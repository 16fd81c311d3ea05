"""Static leader-group layout of the hierarchical control plane (port of
``horovod_tpu/negotiation/layout.py``).

A pure function of ``(world_size, group_size)``: no knob, no runtime state,
so every rank derives the same layout. Group ``g`` covers ranks
``[g*G, min((g+1)*G, world))`` and is led by its smallest rank; where
``G`` does not divide the world the last group is short, and a group of one
leads itself. A new world size gives a new layout, so a dead leader's group
is led by the next rank after a re-form, with no election.
:meth:`GroupLayout.is_leader` is the one rank-local answer: no collective
may be conditioned on it.
"""

from __future__ import annotations


class GroupLayout:
    """``world_size`` member ranks in leader groups of at most
    ``group_size``."""

    __slots__ = ("world_size", "group_size", "n_groups")

    def __init__(self, world_size: int, group_size: int):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        self.world_size = int(world_size)
        self.group_size = int(group_size)
        self.n_groups = -(-self.world_size // self.group_size)  # ceil

    def group_of(self, rank: int) -> int:
        self._check(rank)
        return rank // self.group_size

    def leader_of(self, group: int) -> int:
        self._check_group(group)
        return group * self.group_size

    def leaders(self) -> list[int]:
        return [g * self.group_size for g in range(self.n_groups)]

    def members_of(self, group: int) -> range:
        """Every rank of ``group``, its leader first."""
        self._check_group(group)
        lo = group * self.group_size
        return range(lo, min(lo + self.group_size, self.world_size))

    def is_leader(self, rank: int) -> bool:
        """Whether ``rank`` leads its group (rank-local: never condition a
        collective on it)."""
        self._check(rank)
        return rank % self.group_size == 0

    def _check(self, rank: int) -> None:
        if not 0 <= rank < self.world_size:
            raise ValueError(
                f"rank {rank} out of range [0, {self.world_size})")

    def _check_group(self, group: int) -> None:
        if not 0 <= group < self.n_groups:
            raise ValueError(f"group {group} out of range "
                             f"[0, {self.n_groups})")

    def __repr__(self):
        return (f"GroupLayout(world={self.world_size}, "
                f"G={self.group_size}, groups={self.n_groups})")
