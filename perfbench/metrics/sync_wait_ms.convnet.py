"""Host milliseconds a traced step waits in ``synchronize()``'s
``hvd.SYNC_WAIT.optimizer`` (see ``sync_wait_ms.lm``), in the convnet
cell."""
from perfbench import spans


def read(art):
    return spans.ms_per_step(art, "hvd.SYNC_WAIT.optimizer")
