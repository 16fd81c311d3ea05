"""Two-level collectives: node-local, then across nodes (port of
``horovod_tpu/ops/hierarchical.py``).

The reference Horovod's ``NCCLHierarchicalAllreduce`` shape: a
reduce-scatter within the node, an allreduce of each rank's piece across the
nodes, an allgather within the node::

    allreduce(x) = reduce_scatter(x, local) -> all_reduce(piece, cross)
                                            -> all_gather(piece, local)

Each rank moves the whole vector twice within its node but only
``1/local_size`` of it across nodes. A node is ``ici_size`` consecutive
ranks (:func:`default_ici_size`); the *local* group of rank r holds the
ranks of its node, the *cross* group the ranks of every node with r's index
within the node. Both are ``torch.distributed`` groups made by
``runtime.partition_groups``: by every rank, in one order, at ``init()``
for the default node size, or at the first call of a collective of the
whole world that names another size.

``HVD_HIERARCHICAL_ALLREDUCE`` routes ``grouped_allreduce`` (SUM, and
AVERAGE, which lowers to SUM) and ``HVD_HIERARCHICAL_ALLGATHER`` routes
``allgather`` over the global set through these; other sets, and a world
that is one node or nodes of one rank, stay flat, as in the reference.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import runtime
from ..utils import envs
from .reduce_ops import ReduceOp


def default_ici_size() -> int:
    """Ranks a node: ``HVD_HIERARCHICAL_ICI_SIZE`` if set, else
    ``local_size`` when every node runs the same number of ranks and it
    divides the world, else the world (one node: the two-level ops
    degenerate to flat ones)."""
    override = envs.get_int(envs.HIERARCHICAL_ICI_SIZE, 0)
    if override:
        return override
    n = runtime.size()
    if runtime.is_homogeneous():
        local = runtime.local_size()
        if local and n % local == 0:
            return local
    return n


def level_groups(ici_size: int | None = None) -> tuple:
    """``(local group, cross group, local size, cross size)`` of this rank
    for nodes of ``ici_size`` consecutive ranks (default
    :func:`default_ici_size`). Every rank calls it with the same size."""
    n = runtime.size()
    ici = default_ici_size() if ici_size is None else int(ici_size)
    if ici <= 0 or n % ici:
        raise ValueError(
            f"hierarchical ici_size {ici} must divide world size {n}")
    nodes = n // ici
    local = runtime.partition_groups(
        [range(c * ici, (c + 1) * ici) for c in range(nodes)])
    cross = runtime.partition_groups([range(i, n, ici) for i in range(ici)])
    r = runtime.rank()
    return local[r // ici], cross[r % ici], ici, nodes


def _two_levels() -> bool:
    """Whether the world is more than one node of more than one rank."""
    n, ici = runtime.size(), default_ici_size()
    return 1 < ici < n and n % ici == 0


def make_default_groups() -> None:
    """The default node size's groups, made by every rank at ``init()``
    when the world has two levels."""
    if _two_levels():
        level_groups()


def enabled(knob: str, pset) -> bool:
    """Whether ``knob`` routes a collective over ``pset`` two-level: the
    knob is set, the set is the global one, and the world has two
    levels."""
    return envs.get_bool(knob) and pset.is_global and _two_levels()


_side_streams: dict = {}


def _side_stream(device: torch.device):
    """The stream the two-level steps of ``device``'s buffers run on."""
    stream = _side_streams.get(device)
    if stream is None:
        stream = _side_streams[device] = torch.cuda.Stream(device)
    return stream


def two_level_reducer(local, cross, n_local: int, n_cross: int):
    """A reducer for ``collectives._reduce_async``: the SUM of a flat
    buffer over ``local`` x ``cross`` in three steps, padded with zeros to a
    length ``n_local`` divides. Returns ``(work, result)``. Each step waits
    for the one before, so on the card they run on a side stream: the
    caller's stream waits only for the last step, at ``synchronize()``,
    and a gradient hook's bucket does not hold back the rest of the
    backward pass."""

    def steps(buf, op):
        numel = buf.numel()
        pad = (-numel) % n_local
        flat = torch.cat([buf, buf.new_zeros(pad)]) if pad else buf
        piece = flat
        if n_local > 1:
            piece = flat.new_empty(flat.numel() // n_local)
            dist.reduce_scatter_tensor(piece, flat, op=op, group=local)
        if n_cross > 1:
            dist.all_reduce(piece, op=op, group=cross)
        if n_local == 1:
            return None, piece[:numel]
        out = flat.new_empty(flat.numel())
        work = dist.all_gather_into_tensor(out, piece, group=local,
                                           async_op=True)
        return work, out[:numel]

    def reduce(buf: torch.Tensor, op):
        if not buf.is_cuda:
            return steps(buf, op)
        caller = torch.cuda.current_stream(buf.device)
        side = _side_stream(buf.device)
        side.wait_stream(caller)
        buf.record_stream(side)  # the caller may free it before side reads
        with torch.cuda.stream(side):
            work, out = steps(buf, op)
            if work is None:  # the last step was blocking: mark its end
                work = _StreamWork(side)
        out.record_stream(caller)  # made on side, read by the caller
        return work, out

    return reduce


class _StreamWork:
    """A finished-on-``stream`` marker with a ``Work``'s ``wait`` (the
    current stream waits for it) and ``is_completed``."""

    def __init__(self, stream):
        self._event = torch.cuda.Event()
        self._event.record(stream)

    def wait(self):
        torch.cuda.current_stream().wait_event(self._event)

    def is_completed(self) -> bool:
        return self._event.query()


def two_level_gather(x: torch.Tensor, local, cross, n_local: int,
                     n_cross: int):
    """Every rank's ``x`` (equal shapes), gathered within the node and then
    across the nodes. Returns ``(work, parts)``: ``parts()`` gives the
    rank-ordered list once ``work`` is done (node-major, index within the
    node minor: global rank order)."""
    within = [torch.empty_like(x) for _ in range(n_local)]
    dist.all_gather(within, x, group=local)
    node = torch.cat(within)
    nodes = [torch.empty_like(node) for _ in range(n_cross)]
    work = dist.all_gather(nodes, node, group=cross, async_op=True)
    return work, lambda: [p for blk in nodes for p in blk.split(x.shape[0])]


def hierarchical_allreduce(tensor: torch.Tensor, *,
                           op: ReduceOp = ReduceOp.AVERAGE,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           ici_size: int | None = None,
                           name: str | None = None) -> torch.Tensor:
    """Two-level allreduce of this rank's ``tensor`` over the world
    (reference eager ``hierarchical_allreduce``): SUM or AVERAGE (SUM, then
    a postscale of ``1/size``), with the scale factors of the flat one."""
    del name
    from . import collectives
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"hierarchical allreduce supports SUM/AVERAGE, got {op.name}")
    local, cross, n_local, n_cross = level_groups(ici_size)
    return collectives._reduce_async(
        [tensor], op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, compression=None,
        size=runtime.size(),
        reduce=two_level_reducer(local, cross, n_local, n_cross)
    ).synchronize()[0]


def hierarchical_allgather(tensor: torch.Tensor, *,
                           ici_size: int | None = None,
                           name: str | None = None) -> torch.Tensor:
    """Two-level allgather over the world (reference eager
    ``hierarchical_allgather``): every rank's tensor concatenated along dim
    0 in global rank order; first dims may differ, as for ``allgather``."""
    del name
    from . import collectives
    return collectives._allgather_async(
        tensor, None, *level_groups(ici_size)).synchronize()
