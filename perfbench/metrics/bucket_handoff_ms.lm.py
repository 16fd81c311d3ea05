"""Host milliseconds a traced step spends handing its gradient buckets
to the sync (``hvd.BUCKET_START.optimizer``: gathering a bucket's
gradients, the enqueue, the flush trigger and the hand-off to the flush
executor), on the autograd thread that runs the hooks and on the main
thread."""
from perfbench import spans


def read(art):
    return spans.ms_per_step(art, "hvd.BUCKET_START.optimizer")
