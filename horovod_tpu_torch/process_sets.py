"""Process sets: collectives over subsets of ranks.

The port of ``horovod_tpu/process_sets.py``. A registered set holds a
``torch.distributed`` group over its ranks (NCCL on the card, gloo on the
host), made by ``dist.new_group`` when the set is registered: in
:func:`add_process_set`, or in ``init(process_sets=[...])``. ``new_group``
must be called by every rank of the world, members or not, in the same
order, so registering and removing a set are calls that every rank makes.
A collective given ``process_set=`` runs over the set's group; a rank
outside the set raises before it enters one.

Ids come from a table with a sorted free-list, identical rank lists share
one set, and id 0 (all ranks) cannot be removed. Adding a set after
``init`` needs ``HVD_DYNAMIC_PROCESS_SETS=1`` or
``init(process_sets="dynamic")``, as in the reference.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import torch.distributed as dist

from . import runtime


class ProcessSet:
    """A subset of global ranks over which collectives run (reference
    ``horovod.ProcessSet``): created with a rank list, bound to an id and a
    group once registered."""

    def __init__(self, ranks: Sequence[int] | None = None):
        self.process_set_id: int | None = None
        self._ranks: list[int] | None = (sorted(ranks) if ranks is not None
                                         else None)
        self._group = None  # set on the table's own registered object

    @property
    def ranks(self) -> list[int]:
        if self._ranks is None:
            return list(range(runtime.size()))
        return list(self._ranks)

    def size(self) -> int:
        return len(self.ranks)

    def included(self, global_rank: int | None = None) -> bool:
        """Whether ``global_rank`` (default: this rank) is in the set."""
        r = runtime.rank() if global_rank is None else global_rank
        return r in set(self.ranks)

    def rank(self, global_rank: int | None = None) -> int:
        """Rank *within* the set of a global rank (-1 if not included)."""
        r = runtime.rank() if global_rank is None else global_rank
        try:
            return self.ranks.index(r)
        except ValueError:
            return -1

    @property
    def is_global(self) -> bool:
        return self.ranks == list(range(runtime.size()))

    def group(self):
        """The ``torch.distributed`` group of this rank's collectives over
        the set: None (the default group) for the set of all ranks. Raises
        on a rank outside the set, and for a set that is not registered in
        the current runtime. The group is that of the same ranks'
        registration in the current runtime, so a set held across
        ``shutdown()``/``init()`` runs over the new runtime's group."""
        if self.is_global:
            return None
        if not self.included():
            raise ValueError(
                f"rank {runtime.rank()} is not a member of {self!r}; only "
                "its members may call a collective over it")
        registered = runtime.process_set_table().find(self.ranks)
        if registered is None:
            raise ValueError(
                f"{self!r} is not registered in this runtime; register it "
                "on every rank with add_process_set() or "
                "init(process_sets=...)")
        return registered._group

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.process_set_id}, ranks={self.ranks})"


class ProcessSetTable:
    """Id-keyed registry with a sorted free-list (reference
    ``ProcessSetTable``). ``new_group(ranks)`` makes a registered set's
    group; ``destroy_group(group)`` ends it."""

    def __init__(self, world_size: int,
                 new_group: Callable = dist.new_group,
                 destroy_group: Callable = dist.destroy_process_group):
        self._lock = threading.Lock()
        self._world_size = world_size
        self._new_group = new_group
        self._destroy_group = destroy_group
        self._table: dict[int, ProcessSet] = {}
        self._free_ids: list[int] = []
        self.dynamic_enabled = False
        ps = ProcessSet(list(range(world_size)))
        ps.process_set_id = 0
        self._table[0] = ps
        self._next_id = 1

    def add(self, ranks: Sequence[int], force: bool = False) -> ProcessSet:
        if not force and not self.dynamic_enabled:
            raise RuntimeError(
                "Dynamic process sets are disabled; set "
                "HVD_DYNAMIC_PROCESS_SETS=1 or pass process_sets to "
                "hvd.init() (reference gates identically, "
                "operations.cc:606-607).")
        ranks = sorted(set(ranks))
        for r in ranks:
            if not 0 <= r < self._world_size:
                raise ValueError(
                    f"rank {r} out of range [0, {self._world_size})")
        with self._lock:
            for ps in self._table.values():
                if ps.ranks == ranks:
                    return ps  # identical sets are one set
            ps = ProcessSet(ranks)
            ps._group = self._new_group(ranks)
            if self._free_ids:
                ps.process_set_id = self._free_ids.pop(0)
            else:
                ps.process_set_id = self._next_id
                self._next_id += 1
            self._table[ps.process_set_id] = ps
            return ps

    def remove(self, ps: ProcessSet) -> None:
        if ps.process_set_id in (None, 0):
            raise ValueError("cannot remove the global process set (id 0)")
        with self._lock:
            registered = self._table.pop(ps.process_set_id, None)
            if registered is not None:
                self._free_ids.append(ps.process_set_id)
                self._free_ids.sort()
                self._end(registered)
            ps.process_set_id = None

    def _end(self, ps: ProcessSet) -> None:
        group, ps._group = ps._group, None
        if group not in (None, dist.GroupMember.NON_GROUP_MEMBER):
            self._destroy_group(group)

    def clear(self, end_groups: bool = True) -> None:
        """End every set's group (at ``shutdown()``). ``end_groups=False``
        only lets go of them: the caller aborts the whole world at once."""
        with self._lock:
            for ps in self._table.values():
                if end_groups:
                    self._end(ps)
                else:
                    ps._group = None

    def find(self, ranks: Sequence[int]) -> ProcessSet | None:
        with self._lock:
            return next((ps for ps in self._table.values()
                         if ps.ranks == list(ranks)), None)

    def get(self, ps_id: int) -> ProcessSet:
        with self._lock:
            return self._table[ps_id]

    def ids(self) -> list[int]:
        with self._lock:
            return sorted(self._table)


#: The always-present set of all ranks (id 0).
global_process_set = ProcessSet()
global_process_set.process_set_id = 0


def _resolve(process_set: ProcessSet | None) -> ProcessSet:
    return global_process_set if process_set is None else process_set


def add_process_set(process_set: ProcessSet | Sequence[int]) -> ProcessSet:
    """Register a process set (reference ``add_process_set``) and make its
    group. Every rank of the world calls it, members or not, and all in
    the same order: ``dist.new_group`` is a call of the whole world."""
    if not isinstance(process_set, ProcessSet):
        process_set = ProcessSet(list(process_set))
    registered = runtime.process_set_table().add(process_set.ranks)
    process_set.process_set_id = registered.process_set_id
    return registered


def remove_process_set(process_set: ProcessSet) -> None:
    """Unregister a process set and end its group. Every rank calls it, in
    the same order as the other registrations."""
    runtime.process_set_table().remove(process_set)
    from .ops import dispatch_cache  # its plans name the set's id
    dispatch_cache.invalidate("process set removed")
