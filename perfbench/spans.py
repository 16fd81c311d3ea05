"""The arithmetic of the metrics that read the program's own spans: the
``hvd.<ACTIVITY>.<lane>`` ranges that ``horovod_tpu_torch.timeline.span``
opens while ``torch.profiler`` records the calling thread, found by name
among the traced block's host spans of rank 0. A step is a
``perfbench.step`` span of the block. A reader returns None where the
trace holds none of its spans: an untraced run, or a program that does
not record them."""

from __future__ import annotations

from . import readers
from .frozen import trace

# the gradient sync's and the optimizer's boundaries (optim/__init__.py)
SYNC = ("hvd.BUCKET_START.optimizer", "hvd.SYNC_WAIT.optimizer",
        "hvd.SYNC_UNPACK.optimizer", "hvd.OPTIMIZER_STEP.optimizer")


def _host(art: readers.Artefacts, names) -> list | None:
    """``(start, end)`` of rank 0's host spans named in ``names``, or None
    where its trace holds none."""
    t = art.lead.get("trace")
    if not t:
        return None
    got = [(s, e) for name, s, e in t["host"] if name in names]
    return got or None


def ms_per_step(art: readers.Artefacts, name: str):
    """Host milliseconds a traced step spent inside the spans ``name``
    (summed: a span of one name never encloses another)."""
    got = _host(art, (name,))
    steps = _host(art, ("perfbench.step",))
    if got is None or steps is None:
        return None
    return sum(e - s for s, e in got) / 1e3 / len(steps)


def idle_share_pct(art: readers.Artefacts):
    """Share of the traced block's device-idle time (the gaps of the
    union of device intervals, from the block's start to its end, as
    ``device_idle_pct`` counts them) during which any span of ``SYNC``
    is open on any thread, in percent."""
    got = _host(art, SYNC)
    block = readers._block(art.lead)
    if got is None or block is None:
        return None
    _, dev, start, end = block
    idle = trace.gaps(dev, start, end)
    total = trace.measure(idle)
    if total <= 0:
        return None
    # inclusion-exclusion: |idle & spans| = |idle| + |spans| - |both|
    inside = total + trace.measure(got) - trace.measure(idle + got)
    return 100.0 * inside / total
