"""Adasum: scale-invariant gradient combination (port of
``horovod_tpu/ops/adasum.py``).

Vector-halving distance-doubling (VHDD): at level L rank r pairs with
r ^ L; each keeps the half of its current segment that its bit names,
sends the other half, and combines what it keeps with what it receives::

    a' = (1 - a.b / (2 |a|^2)) a + (1 - a.b / (2 |b|^2)) b

The statistics [a.b, |a|^2, |b|^2] are summed over the block of 2L ranks
that shares the logical vectors (the reference's ``psum`` over
``axis_index_groups``), here by recursive doubling of point-to-point
exchanges inside the block, so no group has to be made for it; they
accumulate in float32 for bf16 and fp16 inputs too. A reverse phase
gathers the segments back. A member count that is not a power of two folds
its extra ranks into the leading power-of-two block first and sends them the
result afterwards. A process set runs the same schedule over its member
list; every exchange is a ``dist.batch_isend_irecv`` pair between global
ranks.

A tensor list is fused into one float32 buffer with one set of coefficients
per tensor: each combine sums the statistics of each tensor's elements in
its part (a tree reduction per tensor) and reduces 3 x n_tensors floats a
level. Halving
may cut a tensor across segments; the partial sums still add up to the
tensor's own, so the result is that of one Adasum per tensor, as the
reference computes it.

The two-level variant (reference ``AdasumGpuAllreduceOp``): a SUM
reduce-scatter inside the node, Adasum across the nodes on each piece with
the statistics also summed over the node (each logical vector is spread
over it), then an allgather inside the node.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import runtime
from . import program_issue


def _coeffs(stats: torch.Tensor):
    """The combine coefficients from ``stats`` (3, n): [a.b, |a|^2, |b|^2]
    per tensor; a coefficient is 1 when its norm is 0, as in the
    reference."""
    dot, na, nb = stats
    ac = torch.where(na > 0, 1.0 - dot / (2.0 * torch.where(na > 0, na, 1.0)),
                     1.0)
    bc = torch.where(nb > 0, 1.0 - dot / (2.0 * torch.where(nb > 0, nb, 1.0)),
                     1.0)
    return ac, bc


def combine(a: torch.Tensor, b: torch.Tensor, lengths,
            reduce_stats=None) -> torch.Tensor:
    """The fused per-tensor combine of one VHDD level: ``a`` and ``b`` are
    this rank's parts of the logical vectors, ``lengths`` the number of
    their elements that each tensor holds, in order (0 for a tensor this
    part does not reach). The statistics of each tensor are summed by a
    tree reduction in ``a``'s dtype; ``reduce_stats`` sums the (3, n)
    statistics over the ranks that share the vectors."""
    parts = torch.stack([a * b, a * a, b * b])
    stats = torch.stack([p.sum(dim=1) for p in parts.split(lengths, dim=1)],
                        dim=1)
    if reduce_stats is not None:
        stats = reduce_stats(stats)
    ac, bc = _coeffs(stats)
    if len(lengths) > 1:  # each tensor's coefficient over its elements
        ac = torch.cat([c.expand(k) for c, k in zip(ac, lengths)])
        bc = torch.cat([c.expand(k) for c, k in zip(bc, lengths)])
    return ac * a + bc * b


def _lengths(bounds, off: int, m: int) -> list:
    """The elements of ``[off, off + m)`` that each tensor holds, the
    tensors laid out at the cumulative offsets ``bounds``."""
    return [max(0, min(hi, off + m) - max(lo, off))
            for lo, hi in zip(bounds, bounds[1:])]


def _exchange(send: torch.Tensor, peer: int) -> torch.Tensor:
    """``send`` to the global rank ``peer``, and what it sends back."""
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), peer),
           dist.P2POp(dist.irecv, recv, peer)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _send(t: torch.Tensor, peer: int) -> None:
    for work in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, t.contiguous(), peer)]):
        work.wait()


def _recv_like(t: torch.Tensor, peer: int) -> torch.Tensor:
    recv = torch.empty_like(t)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.irecv, recv, peer)]):
        work.wait()
    return recv


def _block_sum(stats, active, pos, block):
    """``stats`` summed over the ``block`` consecutive positions of
    ``active`` that hold ``pos``, by recursive doubling. Addition
    commutes, so every rank of the block ends with the same bits."""
    step = 1
    while step < block:
        stats = stats + _exchange(stats, active[pos ^ step])
        step <<= 1
    return stats


def _pow2_floor(n: int) -> int:
    p = 1
    while (p << 1) <= n:
        p <<= 1
    return p


def _vhdd(seg, bounds, members, pos, stats_extra=None):
    """VHDD Adasum of the flat float buffer ``seg`` (its length a multiple
    of the power-of-two part of ``members``; its tensors at the cumulative
    offsets ``bounds``) over the global ranks ``members``, this rank at
    ``pos``. ``stats_extra`` also sums the statistics over other ranks
    (the two-level variant's node). Returns the combined buffer, the same
    on every member."""
    p = _pow2_floor(len(members))
    extras = len(members) - p

    def reduce_with(block_of):
        def reduce(stats):
            stats = block_of(stats)
            return stats_extra(stats) if stats_extra is not None else stats
        return reduce

    # fold the non-power-of-two tail into the head (nearest_power_2)
    if extras and pos >= p:
        _send(seg, members[pos - p])
    elif extras and pos < extras:
        recv = _recv_like(seg, members[p + pos])
        seg = combine(seg, recv, _lengths(bounds, 0, seg.numel()),
                      stats_extra)
    if pos < p:
        active = members[:p]
        off, m, level = 0, seg.numel(), 1
        while level < p:  # halving
            half = m // 2
            bit = (pos // level) % 2
            keep = seg[bit * half:(bit + 1) * half]
            recv = _exchange(seg[(1 - bit) * half:(2 - bit) * half],
                             active[pos ^ level])
            a, b = (keep, recv) if bit == 0 else (recv, keep)
            off += bit * half
            block = 2 * level
            seg = combine(a, b, _lengths(bounds, off, half), reduce_with(
                lambda s, block=block: _block_sum(s, active, pos, block)))
            m = half
            level <<= 1
        level = p >> 1
        while level >= 1:  # doubling
            bit = (pos // level) % 2
            recv = _exchange(seg, active[pos ^ level])
            seg = torch.cat([seg, recv] if bit == 0 else [recv, seg])
            level >>= 1
    # unfold: the folded tail gets the result
    if extras and pos < extras:
        _send(seg, members[p + pos])
    elif extras and pos >= p:
        seg = _recv_like(seg, members[pos - p])
    return seg


@dataclasses.dataclass(frozen=True)
class Route:
    """Where an Adasum runs: over the global ranks ``members``, or, with
    ``local_ranks`` set, two-level: a SUM over this rank's node
    ``local_ranks`` (their group ``local``), then Adasum across the
    ``members`` that share this rank's place in their nodes. ``scale``
    multiplies the result (the composed step's mean over its model axes,
    which the node's sum includes)."""
    members: tuple
    local: object = None
    local_ranks: tuple = ()
    scale: float = 1.0


def flat_route(pset) -> Route:
    return Route(members=tuple(pset.ranks))


def two_level_route(local, local_ranks, members, scale: float = 1.0):
    """The two-level route: the node ``local_ranks`` (group ``local``),
    Adasum across ``members``."""
    return Route(members=tuple(members), local=local,
                 local_ranks=tuple(local_ranks), scale=scale)


def _pad(t: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-t.numel()) % multiple
    return torch.cat([t, t.new_zeros(pad)]) if pad else t


@program_issue.issue_serialized
def reduce_tensors(tensors, route: Route) -> list:
    """Adasum of each tensor of ``tensors`` over ``route``, fused into one
    float32 buffer (float64 stays float64) with one set of coefficients
    per tensor; each result in its tensor's dtype and shape."""
    tensors = list(tensors)
    if not tensors:
        return []
    members = list(route.members)
    me = runtime.rank()
    if me not in members:
        raise ValueError(f"rank {me} is not a member of the Adasum ranks "
                         f"{members}")
    if len(members) == 1 and not route.local_ranks:
        return [t.clone() for t in tensors]
    work = (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.reshape(-1).to(work) for t in tensors])
    bounds = [0]
    for k in sizes:
        bounds.append(bounds[-1] + k)
    p = _pow2_floor(len(members))
    pos = members.index(me)
    if not route.local_ranks:
        seg = _pad(flat, p)
        bounds[-1] = seg.numel()  # the padding counts to the last tensor
        out = _vhdd(seg, bounds, members, pos)
    else:
        n_local, group = len(route.local_ranks), route.local
        full = _pad(flat, n_local)
        piece = full.new_empty(full.numel() // n_local)
        if n_local > 1:
            dist.reduce_scatter_tensor(piece, full, group=group)
        else:
            piece = full
        start = route.local_ranks.index(me) * piece.numel()
        seg = _pad(piece, p)
        # the tensors' offsets within this rank's piece, the padding
        # counted to the last tensor
        part = [min(max(b - start, 0), piece.numel()) for b in bounds]
        part[-1] = seg.numel()

        def over_node(stats):
            if n_local > 1:
                dist.all_reduce(stats, group=group)
            return stats

        seg = _vhdd(seg, part, members, pos, over_node)
        piece = seg[:piece.numel()].contiguous()
        if n_local > 1:
            out = piece.new_empty(full.numel())
            dist.all_gather_into_tensor(out, piece, group=group)
        else:
            out = piece
    if route.scale != 1.0:
        out = out * route.scale
    results, at = [], 0
    for t, k in zip(tensors, sizes):
        results.append(out[at:at + k].view(t.shape).to(t.dtype))
        at += k
    return results


def route_for(pset) -> Route:
    """The route of an Adasum over ``pset``: two-level where
    ``HVD_HIERARCHICAL_ALLREDUCE`` applies to the set (the global set of
    a world of several nodes of several ranks), as in the reference;
    else flat over the set's members."""
    from ..utils import envs
    from . import hierarchical
    if hierarchical.enabled(envs.HIERARCHICAL_ALLREDUCE, pset):
        local, _, ici, nodes = hierarchical.level_groups()
        r = runtime.rank()
        node = r // ici
        return two_level_route(local, range(node * ici, (node + 1) * ici),
                               [r % ici + k * ici for k in range(nodes)])
    return flat_route(pset)


def adasum_allreduce(tensor: torch.Tensor, *,
                     process_set=None) -> torch.Tensor:
    """Adasum allreduce of this rank's ``tensor`` over ``process_set``
    (reference ``adasum_allreduce``): two-level where
    ``HVD_HIERARCHICAL_ALLREDUCE`` applies to the set. Every member gets
    the same combined tensor, in ``tensor``'s dtype."""
    from ..process_sets import _resolve
    pset = _resolve(process_set)
    if not pset.included():
        raise ValueError(
            f"rank {runtime.rank()} is not a member of {pset!r}; only its "
            "members may call a collective over it")
    return reduce_tensors([tensor], route_for(pset))[0]
