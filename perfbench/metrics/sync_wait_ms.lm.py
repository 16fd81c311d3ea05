"""Host milliseconds a traced step waits in ``synchronize()``'s
``hvd.SYNC_WAIT.optimizer``: until the flush pipeline has issued each
bucket and its collectives are waited on, before the unpack."""
from perfbench import spans


def read(art):
    return spans.ms_per_step(art, "hvd.SYNC_WAIT.optimizer")
