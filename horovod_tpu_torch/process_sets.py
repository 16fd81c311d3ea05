"""Process sets: the global set only.

The port of ``horovod_tpu/process_sets.py``. Collectives run over the whole
world, :data:`global_process_set`, and take no ``process_set`` argument
yet: sets over a subset of ranks are ROADMAP item A16.
"""

from __future__ import annotations

from . import runtime


class ProcessSet:
    """The set of all ranks (reference ``horovod.ProcessSet``)."""

    process_set_id = 0

    @property
    def ranks(self) -> list[int]:
        return list(range(runtime.size()))

    def size(self) -> int:
        return runtime.size()


global_process_set = ProcessSet()


def add_process_set(ranks) -> ProcessSet:
    raise NotImplementedError(
        "process sets over a subset of ranks are not ported yet "
        "(ROADMAP.md queue A, item A16)")
