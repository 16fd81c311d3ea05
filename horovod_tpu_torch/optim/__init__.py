"""Distributed optimizer wrapper (port of ``horovod_tpu/optim/__init__.py``).

:class:`DistributedOptimizer` wraps a ``torch.optim.Optimizer``. Its
``step()`` first averages the parameters' ``.grad`` over the ranks, in
size-bounded buckets taken in reverse traversal order (:func:`_bucket_layout`,
``HVD_BUCKET_BYTES``): every bucket is started as its own fused
``grouped_allreduce_async`` before the first is collected, then the wrapped
optimizer steps. Overlap with the backward pass through gradient hooks, and
``backward_passes_per_step``, are ROADMAP item A15.
"""

from __future__ import annotations

import torch

from ..ops import collectives
from ..ops.compression import Compression, Compressor
from ..ops.reduce_ops import ReduceOp
from ..utils import envs


def _bucket_layout(sizes, cap: int) -> list[list[int]]:
    """Partition leaf indices into contiguous buckets of at most ``cap``
    bytes each, walking the leaves in REVERSE order (the backward pass
    produces the last layers' gradients first). A single leaf larger than
    ``cap`` forms its own bucket. A pure function of the sizes, so every
    rank issues the identical bucket stream."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i in reversed(range(len(sizes))):
        if cur and cur_bytes + sizes[i] > cap:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sizes[i]
    if cur:
        buckets.append(cur)
    return buckets


class DistributedOptimizer:
    """Wrap ``optimizer`` so that its updates see globally reduced gradients
    (reference ``hvd.DistributedOptimizer``). ``op``, ``compression`` and
    the scale factors apply to every gradient sync. Attributes other than
    ``step``/``synchronize`` are the wrapped optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer, *,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 compression: type[Compressor] = Compression.none,
                 prescale_factor: float = 1.0, postscale_factor: float = 1.0):
        self.optimizer = optimizer
        self._sync_kw = dict(op=op, compression=compression,
                             prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor)

    def __getattr__(self, name):
        if name == "optimizer":  # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.optimizer, name)

    def _params(self) -> list[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.grad is not None]

    def synchronize(self) -> None:
        """Reduce every parameter's ``.grad`` across the ranks, in place."""
        grads = [p.grad for p in self._params()]
        if not grads:
            return
        cap = envs.bucket_bytes()
        if cap <= 0:
            buckets = [list(range(len(grads)))]
        else:
            buckets = _bucket_layout(
                [g.numel() * g.element_size() for g in grads], cap)
        handles = [(idxs, collectives.grouped_allreduce_async(
            [grads[i] for i in idxs], **self._sync_kw)) for idxs in buckets]
        with torch.no_grad():
            for idxs, h in handles:
                for i, r in zip(idxs, h.synchronize()):
                    grads[i].copy_(r)

    def step(self, closure=None):
        self.synchronize()
        return self.optimizer.step(closure)
