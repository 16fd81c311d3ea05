"""Collective operations over ``torch.distributed`` (surface of
``horovod_tpu/ops/collectives.py``).

Tensors are this rank's own: a collective takes one tensor per rank and
returns a new tensor. Grouped calls fuse their tensors into one flat wire
buffer per wire dtype, with the bucketing rule of the JAX package
(:func:`_fusion_buckets`), and issue one ``torch.distributed`` collective per
buffer (NCCL on the card, gloo on the host). Every collective takes
``process_set=`` and runs over that set's group (``process_sets.py``); a
rank outside the set raises before it enters any collective, AVERAGE
divides by the set's size, and a root rank is a global rank of the set.
``allgather`` exchanges every member's shape first (first dims may differ;
other dims that disagree raise on every member instead of hanging one), and
uneven ``alltoall`` exchanges the splits first, so that each member learns
what it receives. The object collectives pickle through
``torch.distributed``'s own.

Dtypes follow the reference: a scale factor on an integer tensor promotes
it to float32 (``x * pre``), a bool SUM or PRODUCT counts in int32, MIN and
MAX of bools stay bool, and ``reducescatter`` of bools raises ``TypeError``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .. import runtime
from ..process_sets import ProcessSet, _resolve
from ..utils import envs
from .compression import NoneCompressor
from .reduce_ops import ReduceOp, handle_average

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def _check_op_dtype(op: ReduceOp, dtype: torch.dtype) -> None:
    if op == ReduceOp.AVERAGE and not (dtype.is_floating_point
                                       or dtype.is_complex
                                       or dtype == torch.bool):
        raise TypeError(
            "ReduceOp.AVERAGE is not supported for integer tensors "
            "(matches the reference's restriction); use SUM.")


def _wire_dtype_of(t: torch.Tensor, compression) -> torch.dtype:
    """The dtype a tensor travels the wire in: the compressor's wire dtype
    for floating tensors, int32 for bools (the reference's psum counts
    them), else the tensor's own."""
    wire = getattr(compression, "wire_dtype", None)
    if wire is not None and t.is_floating_point():
        return wire
    if t.dtype == torch.bool:
        return torch.int32
    return t.dtype


def _reduced_dtype(dtype: torch.dtype, op: ReduceOp,
                   post: float) -> torch.dtype:
    """The dtype the reference returns for an allreduce of ``dtype``: a
    bool SUM or PRODUCT is an int32 count, MIN and MAX keep bools, and a
    postscale promotes as ``x * post`` does (an integer to float32)."""
    if dtype == torch.bool and op not in (ReduceOp.MIN, ReduceOp.MAX):
        dtype = torch.int32
    if post != 1.0:
        dtype = torch.result_type(torch.empty((), dtype=dtype), post)
    return dtype


def _is_custom_compressor(compression) -> bool:
    """A compressor with its own compress/decompress pair and no cast-style
    ``wire_dtype`` (reference ``_is_custom_compressor``): only it knows the
    wire format, so it wraps the call instead of riding the fusion."""
    return (compression is not None
            and getattr(compression, "wire_dtype", None) is None
            and hasattr(compression, "compress")
            and compression is not NoneCompressor)


def _fusion_buckets(tensors, threshold: int, elem_count, dtype_of=None):
    """THE fusion bucketing rule: group indices by (wire) dtype, then split
    each group into buckets whose total bytes stay <= ``threshold``; a
    single oversized tensor gets its own bucket. ``elem_count(t)`` gives a
    tensor's element count, ``dtype_of(i)`` the wire dtype of tensor ``i``
    (default: its own dtype). Yields ``(dtype, [indices])``."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        dt = dtype_of(i) if dtype_of is not None else t.dtype
        by_dtype.setdefault(dt, []).append(i)
    for dt, idxs in by_dtype.items():
        bucket: list = []
        bucket_bytes = 0
        for i in idxs:
            nbytes = elem_count(tensors[i]) * dt.itemsize
            if bucket and bucket_bytes + nbytes > threshold:
                yield dt, bucket
                bucket, bucket_bytes = [], 0
            bucket.append(i)
            bucket_bytes += nbytes
        if bucket:
            yield dt, bucket


def _fuse_by_dtype(tensors: Sequence[torch.Tensor], wire_dtypes=None,
                   out_dtypes=None):
    """Pack tensors into flat wire buffers, one per bucket of
    :func:`_fusion_buckets` (capped at ``HVD_FUSION_THRESHOLD``), casting
    each to its wire dtype. Returns ``(buffers, metas)``; a meta holds the
    dtype each tensor comes back in (``out_dtypes``, default its own)."""
    bufs, metas = [], []
    wire_of = (lambda i: wire_dtypes[i]) if wire_dtypes is not None else None
    outs = out_dtypes or [t.dtype for t in tensors]
    for dt, idxs in _fusion_buckets(tensors, envs.fusion_threshold_bytes(),
                                    lambda t: t.numel(), dtype_of=wire_of):
        bufs.append(torch.cat([tensors[i].reshape(-1).to(dt) for i in idxs]))
        metas.append((idxs, [tensors[i].shape for i in idxs],
                      [outs[i] for i in idxs]))
    return bufs, metas


def _split_fused(bufs, metas, count: int) -> list:
    """Inverse of :func:`_fuse_by_dtype`: split each flat buffer back into
    its tensors, cast to each tensor's result dtype."""
    results: list = [None] * count
    for buf, (idxs, shapes, srcs) in zip(bufs, metas):
        pieces = buf.split([s.numel() for s in shapes])
        for i, piece, shape, src in zip(idxs, pieces, shapes, srcs):
            results[i] = piece.view(shape).to(src)
    return results


class Handle:
    """Completion handle of an ``*_async`` collective. ``synchronize()``
    waits for the collective (on the card: orders the current stream after
    it), applies the postscale, unpacks, and caches the result."""

    def __init__(self, works=(), finish=None, result=None):
        self._works = list(works)
        self._finish = finish
        self._result = result
        self._done = finish is None

    def synchronize(self):
        if not self._done:
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._done = True
            self._works, self._finish = [], None
        return self._result

    def poll(self) -> bool:
        """Whether the collective has finished, without waiting (on the
        card: whether its NCCL work has run)."""
        return self._done or all(w.is_completed() for w in self._works)

    def then(self, fn) -> "Handle":
        """A handle over the same collective whose result is
        ``fn(this handle's result)``; use it in place of this one."""
        if self._done:
            return Handle(result=fn(self._result))
        finish = self._finish
        return Handle(self._works, lambda: fn(finish()))


def poll(handle: Handle) -> bool:
    """Whether ``handle``'s collective has finished (reference ``poll``)."""
    return handle.poll()


def synchronize(handle: Handle):
    """Wait for ``handle``'s collective and return its result (reference
    ``synchronize``)."""
    return handle.synchronize()


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], *,
                            op: ReduceOp = ReduceOp.AVERAGE,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=None,
                            process_set: ProcessSet | None = None,
                            name: str | None = None) -> Handle:
    """Start a fused allreduce of a tensor list over ``process_set``
    (reference ``grouped_allreduce_async``). AVERAGE lowers to SUM with a
    postscale of ``1/size`` of the set. The scale factors multiply out of
    place, so an integer tensor comes back float32 as in the reference.
    ``compression`` sends floating tensors in its wire dtype, and results
    come back in each tensor's own dtype; a compressor with its own
    ``compress``/``decompress`` and no wire dtype wraps each tensor and
    reduces what it makes, without wire-dtype fusion."""
    del name  # labels the op in the reference's timeline; no timeline here
    tensors = list(tensors)
    pset = _resolve(process_set)
    group = pset.group()
    if not tensors:
        return Handle(result=[])
    for t in tensors:
        _check_op_dtype(op, t.dtype)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP.md queue A, item A9b)")
    if _is_custom_compressor(compression):
        pairs = [compression.compress(t) for t in tensors]
        handle = grouped_allreduce_async(
            [c for c, _ in pairs], op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=pset)
        return handle.then(lambda outs: [
            compression.decompress(o, ctx)
            for o, (_, ctx) in zip(outs, pairs)])
    lowered, post = handle_average(op, pset.size(), postscale_factor)
    if op == ReduceOp.AVERAGE:  # the mean of bools is a float32 share
        tensors = [t.float() if t.dtype == torch.bool else t
                   for t in tensors]
    if prescale_factor != 1.0:
        tensors = [t * prescale_factor for t in tensors]
    wire = [_wire_dtype_of(t, compression) for t in tensors]
    outs = [_reduced_dtype(t.dtype, lowered, post) for t in tensors]
    bufs, metas = _fuse_by_dtype(tensors, wire, outs)
    works = [dist.all_reduce(buf, op=_DIST_OPS[lowered], group=group,
                             async_op=True) for buf in bufs]

    def finish():
        scaled = bufs
        if post != 1.0:  # out of place: an integer buffer turns float32
            scaled = [b.mul_(post) if b.is_floating_point() else b * post
                      for b in bufs]
        return _split_fused(scaled, metas, len(tensors))

    return Handle(works, finish)


def grouped_allreduce(tensors: Sequence[torch.Tensor], **kw) -> list:
    """Fused allreduce of a tensor list; see :func:`grouped_allreduce_async`."""
    return grouped_allreduce_async(tensors, **kw).synchronize()


def allreduce_async(tensor: torch.Tensor, **kw) -> Handle:
    """Start an allreduce of one tensor (reference ``allreduce_async``);
    keywords as for :func:`grouped_allreduce_async`."""
    return grouped_allreduce_async([tensor], **kw).then(lambda r: r[0])


def allreduce(tensor: torch.Tensor, **kw) -> torch.Tensor:
    """Allreduce one tensor (reference ``hvd.allreduce``); keywords as for
    :func:`grouped_allreduce_async`."""
    return grouped_allreduce([tensor], **kw)[0]


def _check_root(root_rank: int, pset: ProcessSet) -> None:
    """``root_rank`` is a global rank, and must be in the set (reference
    ``broadcast``)."""
    if root_rank not in pset.ranks:
        raise ValueError(
            f"root_rank {root_rank} not in process set {pset.ranks}")


def grouped_broadcast_async(tensors: Sequence[torch.Tensor], root_rank: int,
                            *, process_set: ProcessSet | None = None,
                            name: str | None = None) -> Handle:
    """Start a broadcast of a tensor list from the global rank
    ``root_rank`` over ``process_set``, fused into one wire buffer per
    dtype; the handle's result is the new tensors."""
    del name
    tensors = list(tensors)
    pset = _resolve(process_set)
    group = pset.group()
    if not tensors:
        return Handle(result=[])
    _check_root(root_rank, pset)
    bufs, metas = _fuse_by_dtype(tensors)
    works = [dist.broadcast(buf, src=root_rank, group=group, async_op=True)
             for buf in bufs]
    return Handle(works, lambda: _split_fused(bufs, metas, len(tensors)))


def grouped_broadcast(tensors: Sequence[torch.Tensor], root_rank: int,
                      **kw) -> list:
    """Broadcast a tensor list from ``root_rank``, fused into one wire
    buffer per dtype. Returns new tensors."""
    return grouped_broadcast_async(tensors, root_rank, **kw).synchronize()


def broadcast_async(tensor: torch.Tensor, root_rank: int, **kw) -> Handle:
    """Start a broadcast of one tensor from ``root_rank`` (reference
    ``hvd.broadcast_async``); ``synchronize()`` gives the new tensor."""
    return grouped_broadcast_async([tensor], root_rank, **kw).then(
        lambda r: r[0])


def broadcast(tensor: torch.Tensor, root_rank: int, **kw) -> torch.Tensor:
    """Broadcast one tensor from ``root_rank`` (reference ``hvd.broadcast``)."""
    return broadcast_async(tensor, root_rank, **kw).synchronize()


def barrier(*, process_set: ProcessSet | None = None) -> None:
    """Block until every rank of ``process_set`` reaches the barrier."""
    dist.barrier(group=_resolve(process_set).group())


_MAX_DIMS = 8  # rank of the shapes allgather's metadata exchange carries


def _all_shapes(x: torch.Tensor, pset: ProcessSet, group) -> list:
    """Every member's shape of ``x``, in rank order, through one allgather
    of a fixed-length int64 row (its rank, then its dims)."""
    if x.dim() > _MAX_DIMS:
        raise ValueError(f"allgather takes tensors of at most {_MAX_DIMS} "
                         f"dimensions, got {x.dim()}")
    row = torch.zeros(_MAX_DIMS + 1, dtype=torch.int64, device=x.device)
    row[0] = x.dim()
    row[1:1 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    rows = [torch.empty_like(row) for _ in range(pset.size())]
    dist.all_gather(rows, row, group=group)
    return [tuple(r[1:1 + int(r[0])].tolist()) for r in rows]


def allgather_async(tensor: torch.Tensor, *,
                    process_set: ProcessSet | None = None,
                    name: str | None = None) -> Handle:
    """Start an allgather (reference ``hvd.allgather_async``); see
    :func:`allgather`. The shapes are exchanged before this returns; the
    handle's result is the concatenation."""
    del name
    pset = _resolve(process_set)
    group = pset.group()
    x = (tensor.reshape(1) if tensor.dim() == 0 else tensor).contiguous()
    shapes = _all_shapes(x, pset, group)
    if len({s[1:] for s in shapes}) > 1:
        raise ValueError(
            "allgather tensors must agree on every dimension except the "
            f"first, got shapes {shapes}")
    rows = [s[0] for s in shapes]
    width = max(rows)
    if width == 0:
        return Handle(result=x.new_empty((0,) + x.shape[1:]))
    if x.shape[0] < width:  # pad to the widest rank's rows
        x = torch.cat([x, x.new_zeros((width - x.shape[0],) + x.shape[1:])])
    parts = [torch.empty_like(x) for _ in rows]
    work = dist.all_gather(parts, x, group=group, async_op=True)
    return Handle([work], lambda: torch.cat(
        [p[:r] for p, r in zip(parts, rows)]))


def allgather(tensor: torch.Tensor, *,
              process_set: ProcessSet | None = None,
              name: str | None = None) -> torch.Tensor:
    """Concatenate every member's tensor along dim 0, in rank order
    (reference ``hvd.allgather``). First dims may differ between ranks (the
    reference's allgatherv contract): the row counts are exchanged first,
    the rows travel padded to the largest count, and the padding is cut
    off. A 0-d tensor counts as one row."""
    return allgather_async(tensor, process_set=process_set,
                           name=name).synchronize()


def alltoall(tensor: torch.Tensor, splits=None, *,
             process_set: ProcessSet | None = None, name: str | None = None):
    """All-to-all along dim 0 (reference ``hvd.alltoall``).

    Even mode (``splits=None``): the j-th of ``size`` equal chunks goes to
    rank j, and the result concatenates the chunks received, in rank order.
    Uneven mode: ``splits`` is this rank's own row, ``splits[j]`` the rows
    it sends rank j, in order from the top of ``tensor``; the row sum may be
    less than dim 0 (trailing rows are not sent). Returns ``(output,
    recv_splits)``, ``recv_splits[j]`` (int32) the rows received from rank
    j. The JAX package's single controller takes the whole ``(size, size)``
    matrix instead; each of its rows is one rank's ``splits`` here."""
    del name
    pset = _resolve(process_set)
    group = pset.group()
    n = pset.size()
    x = tensor.contiguous()
    d0 = x.shape[0] if x.dim() else 1
    if splits is None:
        if d0 % n != 0:
            raise ValueError(f"alltoall dim0 ({d0}) must be divisible "
                             f"by process set size ({n})")
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    row = torch.as_tensor(splits)
    if row.shape != (n,):
        raise ValueError(f"splits must be one row of length {n}, got shape "
                         f"{tuple(row.shape)}")
    send = [int(s) for s in row.tolist()]
    if min(send) < 0:
        raise ValueError("splits entries must be non-negative")
    if sum(send) > d0:
        raise ValueError(
            f"sum of splits entries exceeds the first dimension ({d0}) "
            "(reference operations.cc:1703-1707)")
    send_t = torch.tensor(send, dtype=torch.int64, device=x.device)
    recv_t = torch.empty_like(send_t)
    dist.all_to_all_single(recv_t, send_t, group=group)
    recv = recv_t.tolist()
    out = x.new_empty((sum(recv),) + x.shape[1:])
    dist.all_to_all_single(out, x[:sum(send)], output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out, torch.tensor(recv, dtype=torch.int32)


def reducescatter(tensor: torch.Tensor, *, op: ReduceOp = ReduceOp.SUM,
                  process_set: ProcessSet | None = None,
                  name: str | None = None) -> torch.Tensor:
    """Reduce every member's tensor and give the set's r-th member the r-th
    of ``size`` equal chunks along dim 0 (reference ``hvd.reducescatter``).
    ``op`` is SUM or AVERAGE (SUM, then a postscale of ``1/size``)."""
    del name
    pset = _resolve(process_set)
    group = pset.group()
    if tensor.dtype == torch.bool:  # the reference's jnp add refuses bools
        raise TypeError(
            "add does not accept dtype bool at position 0. Accepted dtypes "
            "at position 0 are subtypes of integer, floating, "
            "complexfloating.")
    _check_op_dtype(op, tensor.dtype)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise NotImplementedError("reducescatter supports SUM/AVERAGE")
    n = pset.size()
    x = tensor.contiguous()
    if x.dim() == 0 or x.shape[0] % n != 0:
        raise ValueError(f"reducescatter dim0 ({x.shape[0] if x.dim() else 1}"
                         f") must be divisible by process set size ({n})")
    lowered, post = handle_average(op, n, 1.0)
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x, op=_DIST_OPS[lowered], group=group)
    if post != 1.0:
        out.mul_(post)
    return out


def broadcast_object(obj, root_rank: int = 0, *,
                     process_set: ProcessSet | None = None,
                     name: str | None = None):
    """Broadcast a picklable object from the global rank ``root_rank``
    (reference ``broadcast_object``): every member gets the root's
    object."""
    del name
    pset = _resolve(process_set)
    group = pset.group()
    _check_root(root_rank, pset)
    if pset.size() == 1:
        return obj
    box = [obj if runtime.rank() == root_rank else None]
    dist.broadcast_object_list(box, src=root_rank, group=group)
    return box[0]


def allgather_object(obj, *, process_set: ProcessSet | None = None,
                     name: str | None = None) -> list:
    """Every member's picklable object, in rank order (reference
    ``allgather_object``)."""
    del name
    pset = _resolve(process_set)
    group = pset.group()
    if pset.size() == 1:
        return [obj]
    out = [None] * pset.size()
    dist.all_gather_object(out, obj, group=group)
    return out
