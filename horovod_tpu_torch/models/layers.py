"""Layers shared by the port's convnets (ResNet, VGG, Inception V3 and the
MNIST example's ConvNet), with flax's semantics on NCHW tensors held in the
channels-last memory format:

* :func:`conv_padding`, the one place that turns flax's ``"SAME"``,
  ``"VALID"`` or explicit padding into pads for a given input size. XLA's
  ``"SAME"`` pads ``total = max((ceil(n/s) - 1) * s + k - n, 0)``, ``total
  // 2`` low and the rest high, so a 3x3 stride-2 conv on an even input is
  padded (0, 1), which no symmetric ``nn.Conv2d(padding=...)`` gives.
* :class:`Conv` and :class:`Dense`: float32 parameters, compute in ``dtype``
  (flax ``dtype=..., param_dtype=float32``).
* :func:`max_pool`, :func:`avg_pool_same` and :func:`dropout` (flax's
  ``Dropout``, drawing its mask from an explicit ``torch.Generator``).
* :func:`reset_flax_defaults`: flax's default initializers.
* :func:`from_flax_variables`: a ``state_dict`` from a flax model's
  ``params`` and ``batch_stats``. The port names every submodule as flax
  auto-names it, in snake case (``BottleneckBlock_3`` ->
  ``bottleneck_block.3``, ``Conv_0`` -> ``conv.0``), and keeps flax's
  explicit names (``conv_init``, ``norm_proj``), so one rule maps every
  convnet.
"""

from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime
from .sync_batch_norm import BatchNorm

Padding = str | Sequence[tuple[int, int]]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dimension: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_padding(padding: Padding, size: Sequence[int], kernel, strides
                 ) -> list[tuple[int, int]]:
    """(low, high) pads of each spatial dimension, as flax pads an input of
    spatial ``size`` for ``padding`` ``"SAME"``, ``"VALID"`` or explicit
    (low, high) pairs."""
    if padding == "SAME":
        return [same_pads(n, k, s) for n, k, s in zip(size, kernel, strides)]
    if padding == "VALID":
        return [(0, 0)] * len(size)
    return [tuple(p) for p in padding]


def _apply_padding(x, pads, value=0.0):
    """Pad ``x`` (N, C, H, W) by ``pads``; returns the tensor and the
    symmetric padding left for the conv or pool to apply itself."""
    if all(lo == hi for lo, hi in pads):
        return x, tuple(lo for lo, _ in pads)
    (hlo, hhi), (wlo, whi) = pads
    return F.pad(x, (wlo, whi, hlo, hhi), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW input: float32 kernel (O, I, H, W), compute in
    ``dtype``, padding resolved from the input size at every call."""

    def __init__(self, in_features: int, features: int, kernel=(3, 3),
                 strides=(1, 1), padding: Padding = "SAME",
                 use_bias: bool = False, dtype=torch.bfloat16, device=None):
        super().__init__()
        device = runtime.default_device(device)
        self.kernel, self.strides = _pair(kernel), _pair(strides)
        self.padding, self.compute_dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(
            (features, in_features, *self.kernel), device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    def forward(self, x):
        pads = conv_padding(self.padding, x.shape[2:], self.kernel,
                            self.strides)
        x, sym = _apply_padding(x.to(self.compute_dtype), pads)
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.conv2d(x, self.weight.to(self.compute_dtype), bias,
                        self.strides, sym)


class Dense(nn.Linear):
    """flax ``nn.Dense`` with a bias: float32 parameters, compute in
    ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__(in_features, features,
                         device=runtime.default_device(device),
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


def max_pool(x, window: int, strides: int, padding: Padding = "VALID"):
    """flax ``nn.max_pool`` with a square window; padding counts as -inf."""
    pads = conv_padding(padding, x.shape[2:], (window, window),
                        (strides, strides))
    x, sym = _apply_padding(x, pads, value=-math.inf)
    return F.max_pool2d(x, window, strides, sym)


def avg_pool_same(x):
    """flax ``nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``: the
    zero padding counts in the mean (``count_include_pad=True``).

    The pool runs on a contiguous (NCHW) copy and its result returns to
    ``x``'s memory format: CUDA's ``avg_pool2d`` backward on a channels-last
    float32 tensor returns a wrong dx (about 100 % off in relative norm with
    torch 2.11 on an H100; ``testing.pooling_errors`` reads it)."""
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    y = F.avg_pool2d(x.contiguous(), 3, 1, 1, count_include_pad=True)
    return y.contiguous(memory_format=fmt)


def dropout(x, rate: float, training: bool,
            generator: torch.Generator | None = None):
    """flax ``nn.Dropout``: in training, keep each entry with probability
    ``1 - rate`` and scale it by ``1 / (1 - rate)``; the mask comes from
    ``generator`` (on ``x``'s device), else from torch's default one."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


@torch.no_grad()
def reset_flax_defaults(model: nn.Module,
                        generator: torch.Generator | None = None):
    """flax's default initializers, drawn on the host from the CPU
    ``generator`` (a seed gives the same weights on any device): conv and
    dense kernels LeCun normal (truncated at two standard deviations,
    variance 1 / fan_in), biases 0, and each BatchNorm's own
    ``reset_parameters``."""
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return model


def _snake(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", name).lower()


def _port_name(path: Sequence[str]) -> str:
    """``("BottleneckBlock_3", "Conv_0")`` ->
    ``"bottleneck_block.3.conv.0"``."""
    parts = []
    for p in path:
        m = re.fullmatch(r"([A-Za-z]+)_(\d+)", p)
        parts.append(f"{_snake(m[1])}.{m[2]}" if m else p)
    return ".".join(parts)


def _leaves(tree, path=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}


def from_flax_variables(params, batch_stats=None) -> dict:
    """A ``state_dict`` for a port convnet from the flax model's ``params``
    and ``batch_stats`` trees (nested dicts of arrays, e.g. numpy, or a
    gradient tree shaped as ``params``). Conv kernels go from HWIO to OIHW
    and Dense kernels from (in, out) to ``nn.Linear``'s (out, in); BatchNorm
    ``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
    ``running_mean``/``running_var``."""
    sd = {}
    for tree in (params, batch_stats or {}):
        for path, value in _leaves(tree):
            x = np.array(value, dtype=np.float32)
            if path[-1] == "kernel":
                x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
            sd[f"{_port_name(path[:-1])}.{_LEAF_NAMES[path[-1]]}"] = (
                torch.from_numpy(np.ascontiguousarray(x)))
    return sd
