"""The 90th percentile of rank 0's window steps outside the profiled
block, between CUDA events at consecutive step starts: the GPT-2 XL
cells' tail, whose run-to-run spread (host-bound steps) is too wide for
an end-to-end bound."""
from perfbench import readers
from perfbench.frozen import stats


def read(art):
    return stats.percentile(readers.unprofiled(art, "step_ms"), 90.0)
