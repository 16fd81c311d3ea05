"""The 90th percentile of every window step's time on rank 0, between
CUDA events at consecutive step starts on the compute stream."""
from perfbench.frozen import stats


def read(art):
    return stats.percentile(art.lead["step_ms"], 90.0)
