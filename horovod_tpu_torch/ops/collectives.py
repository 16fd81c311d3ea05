"""Collective operations over ``torch.distributed`` (surface of
``horovod_tpu/ops/collectives.py``).

Tensors are this rank's own: a collective takes one tensor per rank and
returns a new tensor. Grouped calls fuse their tensors into one flat wire
buffer per wire dtype, with the bucketing rule of the JAX package
(:func:`_fusion_buckets`), and issue one ``torch.distributed`` collective per
buffer (NCCL on the card, gloo on the host), over the whole world: process
sets over a subset of ranks are ROADMAP item A16. ``allgather`` exchanges
every rank's shape first (first dims may differ; other dims that disagree
raise on every rank instead of hanging one), and uneven ``alltoall``
exchanges the splits first, so that each rank learns what it receives. The
object collectives pickle through ``torch.distributed``'s own.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .. import runtime
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
                                       or dtype.is_complex):
        raise TypeError(
            "ReduceOp.AVERAGE is not supported for integer tensors "
            "(matches the reference's restriction); use SUM.")


def _wire_dtype_of(t: torch.Tensor, compression) -> torch.dtype:
    """The dtype a tensor travels the wire in: the compressor's wire dtype
    for floating tensors, else the tensor's own."""
    wire = getattr(compression, "wire_dtype", None)
    if wire is not None and t.is_floating_point():
        return wire
    return t.dtype


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


def _fuse_by_dtype(tensors: Sequence[torch.Tensor], wire_dtypes=None):
    """Pack tensors into flat wire buffers, one per bucket of
    :func:`_fusion_buckets` (capped at ``HVD_FUSION_THRESHOLD``), casting
    each to its wire dtype. Returns ``(buffers, metas)``."""
    bufs, metas = [], []
    wire_of = (lambda i: wire_dtypes[i]) if wire_dtypes is not None else None
    for dt, idxs in _fusion_buckets(tensors, envs.fusion_threshold_bytes(),
                                    lambda t: t.numel(), dtype_of=wire_of):
        bufs.append(torch.cat([tensors[i].reshape(-1).to(dt) for i in idxs]))
        metas.append((idxs, [tensors[i].shape for i in idxs],
                      [tensors[i].dtype for i in idxs]))
    return bufs, metas


def _split_fused(bufs, metas, count: int) -> list:
    """Inverse of :func:`_fuse_by_dtype`: split each flat buffer back into
    its tensors, cast back to each tensor's source dtype."""
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


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], *,
                            op: ReduceOp = ReduceOp.AVERAGE,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=None, name: str | None = None
                            ) -> Handle:
    """Start a fused allreduce of a tensor list (reference
    ``grouped_allreduce_async``). AVERAGE lowers to SUM with a postscale of
    ``1/size``. ``compression`` sends floating tensors in its wire dtype;
    results come back in each tensor's own dtype."""
    del name  # labels the op in the reference's timeline; no timeline here
    tensors = list(tensors)
    if not tensors:
        return Handle(result=[])
    for t in tensors:
        _check_op_dtype(op, t.dtype)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP.md queue A, item A9)")
    if compression not in (None, NoneCompressor) and getattr(
            compression, "wire_dtype", None) is None:
        raise NotImplementedError(
            "only Compression.none/fp16/bf16 are ported; a compressor with "
            "its own wire format is not")
    lowered, post = handle_average(op, runtime.size(), postscale_factor)
    wire = [_wire_dtype_of(t, compression) for t in tensors]
    bufs, metas = _fuse_by_dtype(tensors, wire)
    works = []
    for buf in bufs:
        if prescale_factor != 1.0:
            buf.mul_(prescale_factor)
        works.append(dist.all_reduce(buf, op=_DIST_OPS[lowered],
                                     async_op=True))

    def finish():
        if post != 1.0:
            for buf in bufs:
                buf.mul_(post)
        return _split_fused(bufs, metas, len(tensors))

    return Handle(works, finish)


def grouped_allreduce(tensors: Sequence[torch.Tensor], **kw) -> list:
    """Fused allreduce of a tensor list; see :func:`grouped_allreduce_async`."""
    return grouped_allreduce_async(tensors, **kw).synchronize()


def allreduce(tensor: torch.Tensor, **kw) -> torch.Tensor:
    """Allreduce one tensor (reference ``hvd.allreduce``); keywords as for
    :func:`grouped_allreduce_async`."""
    return grouped_allreduce([tensor], **kw)[0]


def _check_root(root_rank: int) -> None:
    if not 0 <= root_rank < runtime.size():
        raise ValueError(
            f"root_rank {root_rank} not in the world of {runtime.size()}")


def grouped_broadcast_async(tensors: Sequence[torch.Tensor], root_rank: int,
                            *, name: str | None = None) -> Handle:
    """Start a broadcast of a tensor list from ``root_rank``, fused into one
    wire buffer per dtype; the handle's result is the new tensors."""
    del name
    tensors = list(tensors)
    if not tensors:
        return Handle(result=[])
    _check_root(root_rank)
    bufs, metas = _fuse_by_dtype(tensors)
    works = [dist.broadcast(buf, src=root_rank, async_op=True)
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
    handle = grouped_broadcast_async([tensor], root_rank, **kw)
    return Handle(finish=lambda: handle.synchronize()[0])


def broadcast(tensor: torch.Tensor, root_rank: int, **kw) -> torch.Tensor:
    """Broadcast one tensor from ``root_rank`` (reference ``hvd.broadcast``)."""
    return broadcast_async(tensor, root_rank, **kw).synchronize()


def barrier() -> None:
    """Block until every rank reaches the barrier."""
    dist.barrier()


_MAX_DIMS = 8  # rank of the shapes allgather's metadata exchange carries


def _all_shapes(x: torch.Tensor) -> list:
    """Every rank's shape of ``x``, in rank order, through one allgather of
    a fixed-length int64 row (its rank, then its dims)."""
    if x.dim() > _MAX_DIMS:
        raise ValueError(f"allgather takes tensors of at most {_MAX_DIMS} "
                         f"dimensions, got {x.dim()}")
    row = torch.zeros(_MAX_DIMS + 1, dtype=torch.int64, device=x.device)
    row[0] = x.dim()
    row[1:1 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    rows = [torch.empty_like(row) for _ in range(runtime.size())]
    dist.all_gather(rows, row)
    return [tuple(r[1:1 + int(r[0])].tolist()) for r in rows]


def allgather_async(tensor: torch.Tensor, *, name: str | None = None
                    ) -> Handle:
    """Start an allgather (reference ``hvd.allgather_async``); see
    :func:`allgather`. The shapes are exchanged before this returns; the
    handle's result is the concatenation."""
    del name
    x = (tensor.reshape(1) if tensor.dim() == 0 else tensor).contiguous()
    shapes = _all_shapes(x)
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
    work = dist.all_gather(parts, x, async_op=True)
    return Handle([work], lambda: torch.cat(
        [p[:r] for p, r in zip(parts, rows)]))


def allgather(tensor: torch.Tensor, *, name: str | None = None
              ) -> torch.Tensor:
    """Concatenate every rank's tensor along dim 0, in rank order (reference
    ``hvd.allgather``). First dims may differ between ranks (the
    reference's allgatherv contract): the row counts are exchanged first,
    the rows travel padded to the largest count, and the padding is cut
    off. A 0-d tensor counts as one row."""
    return allgather_async(tensor, name=name).synchronize()


def alltoall(tensor: torch.Tensor, splits=None, *, name: str | None = None):
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
    n = runtime.size()
    x = tensor.contiguous()
    d0 = x.shape[0] if x.dim() else 1
    if splits is None:
        if d0 % n != 0:
            raise ValueError(f"alltoall dim0 ({d0}) must be divisible "
                             f"by process set size ({n})")
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
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
    dist.all_to_all_single(recv_t, send_t)
    recv = recv_t.tolist()
    out = x.new_empty((sum(recv),) + x.shape[1:])
    dist.all_to_all_single(out, x[:sum(send)], output_split_sizes=recv,
                           input_split_sizes=send)
    return out, torch.tensor(recv, dtype=torch.int32)


def reducescatter(tensor: torch.Tensor, *, op: ReduceOp = ReduceOp.SUM,
                  name: str | None = None) -> torch.Tensor:
    """Reduce every rank's tensor and give rank r the r-th of ``size`` equal
    chunks along dim 0 (reference ``hvd.reducescatter``). ``op`` is SUM or
    AVERAGE (SUM, then a postscale of ``1/size``)."""
    del name
    _check_op_dtype(op, tensor.dtype)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise NotImplementedError("reducescatter supports SUM/AVERAGE")
    n = runtime.size()
    x = tensor.contiguous()
    if x.dim() == 0 or x.shape[0] % n != 0:
        raise ValueError(f"reducescatter dim0 ({x.shape[0] if x.dim() else 1}"
                         f") must be divisible by process set size ({n})")
    lowered, post = handle_average(op, n, 1.0)
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x, op=_DIST_OPS[lowered])
    if post != 1.0:
        out.mul_(post)
    return out


def broadcast_object(obj, root_rank: int = 0, *, name: str | None = None):
    """Broadcast a picklable object from ``root_rank`` (reference
    ``broadcast_object``): every rank gets the root's object."""
    del name
    _check_root(root_rank)
    if runtime.size() == 1:
        return obj
    box = [obj if runtime.rank() == root_rank else None]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]


def allgather_object(obj, *, name: str | None = None) -> list:
    """Every rank's picklable object, in rank order (reference
    ``allgather_object``)."""
    del name
    if runtime.size() == 1:
        return [obj]
    out = [None] * runtime.size()
    dist.all_gather_object(out, obj)
    return out
