"""Batch normalization with flax's semantics, local or over the world
(port of ``horovod_tpu/models/sync_batch_norm.py``).

:class:`BatchNorm` is flax ``nn.BatchNorm``, not ``nn.BatchNorm2d``:

* the batch moments E[x] and E[x^2] are taken in float32 (or in the
  input's dtype where that is wider) from the input (bf16 in the models),
  and the variance is ``max(E[x^2] - E[x]^2, 0)``, the biased one;
* the running averages move as ``ra = momentum * ra + (1 - momentum) *
  batch``, with flax's ``momentum`` (0.9 is torch's 0.1), and the running
  variance takes the biased batch variance (``nn.BatchNorm2d`` takes the
  unbiased one, n / (n - 1) larger);
* normalization is computed in that dtype, ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias``, and only the output is cast to ``dtype``;
* ``zero_scale`` initializes the scale to 0 (the last norm of a residual
  block).

:class:`SyncBatchNorm` takes the moments over the whole world: the twin of
flax ``BatchNorm(axis_name=...)``, which ``pmean``s (E[x], E[x^2]) across the
mesh axis. Its forward averages the two moments with the port's
``allreduce`` and its backward averages their cotangents, as XLA
differentiates through the ``pmean``. At a world of one it equals
:class:`BatchNorm`. It runs collectives in training mode, so it needs
``hvd.init()``; in eval mode it reads the running averages, as flax does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .. import runtime
from ..ops import collectives
from ..ops.reduce_ops import ReduceOp


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of an NCHW (or NC) tensor;
    ``momentum`` and ``epsilon`` are flax's. Statistics come from the batch
    in training mode (``model.train()``) and from the running averages in
    eval mode."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=torch.bfloat16,
                 zero_scale: bool = False, device=None):
        super().__init__()
        device = runtime.default_device(device)
        self.momentum, self.epsilon = momentum, epsilon
        self.compute_dtype, self.zero_scale = dtype, zero_scale
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.empty(num_features, device=device))
        self.register_buffer("running_var",
                             torch.empty(num_features, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        """flax's initializers: scale 1 (0 with ``zero_scale``), bias 0,
        running mean 0 and running variance 1."""
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _reduce(self, moments: torch.Tensor) -> torch.Tensor:
        """The (2, C) moments the batch normalizes with: here this rank's
        own."""
        return moments

    def forward(self, x):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            mean, mean2 = self._reduce(torch.stack(
                (x32.mean(dims), x32.square().mean(dims))))
            var = (mean2 - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (x32 - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.compute_dtype)


class _WorldMean(torch.autograd.Function):
    """``allreduce`` average forward and backward: the gradient of a mean
    over the ranks is the mean of the ranks' cotangents (the transpose of
    ``lax.pmean``)."""

    @staticmethod
    def forward(ctx, x):
        return collectives.allreduce(x, op=ReduceOp.AVERAGE)

    @staticmethod
    def backward(ctx, grad):
        return collectives.allreduce(grad.contiguous(), op=ReduceOp.AVERAGE)


class SyncBatchNorm(BatchNorm):
    """:class:`BatchNorm` whose batch moments are averaged over every rank
    of the world (reference ``hvd.SyncBatchNorm``). Every rank must hold
    the same number of samples, as the mean of the ranks' means is the
    global mean only then (flax's ``pmean`` assumes the same)."""

    def _reduce(self, moments):
        return _WorldMean.apply(moments)
