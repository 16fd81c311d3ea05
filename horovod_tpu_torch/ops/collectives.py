"""Collective operations over ``torch.distributed`` (surface of
``horovod_tpu/ops/collectives.py``).

Tensors are this rank's own: a collective takes one tensor per rank and
returns a new tensor. Grouped calls fuse their tensors into one flat wire
buffer per wire dtype, with the bucketing rule of the JAX package
(:func:`_fusion_buckets`), and issue one ``torch.distributed`` collective per
buffer (NCCL on the card, gloo on the host), over the whole world: process
sets over a subset of ranks are ROADMAP item A16.
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


def grouped_broadcast(tensors: Sequence[torch.Tensor], root_rank: int, *,
                      name: str | None = None) -> list:
    """Broadcast a tensor list from ``root_rank``, fused into one wire
    buffer per dtype. Returns new tensors."""
    del name
    tensors = list(tensors)
    if not tensors:
        return []
    if not 0 <= root_rank < runtime.size():
        raise ValueError(
            f"root_rank {root_rank} not in the world of {runtime.size()}")
    bufs, metas = _fuse_by_dtype(tensors)
    for buf in bufs:
        dist.broadcast(buf, src=root_rank)
    return _split_fused(bufs, metas, len(tensors))


def broadcast(tensor: torch.Tensor, root_rank: int, **kw) -> torch.Tensor:
    """Broadcast one tensor from ``root_rank`` (reference ``hvd.broadcast``)."""
    return grouped_broadcast([tensor], root_rank, **kw)[0]


def barrier() -> None:
    """Block until every rank reaches the barrier."""
    dist.barrier()
