"""Host milliseconds a traced step spends in the wrapped optimizer's
``step()`` (``hvd.OPTIMIZER_STEP.optimizer``): Adam's launches."""
from perfbench import spans


def read(art):
    return spans.ms_per_step(art, "hvd.OPTIMIZER_STEP.optimizer")
