"""Host milliseconds a traced step spends in ``hvd.SYNC_UNPACK.optimizer``:
each bucket's postscale and split, and the copies back into ``.grad``."""
from perfbench import spans


def read(art):
    return spans.ms_per_step(art, "hvd.SYNC_UNPACK.optimizer")
