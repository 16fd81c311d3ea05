"""ResNet v1.5 family (port of ``horovod_tpu/models/resnet.py``).

The same models as the flax ones, as ``nn.Module``s on NCHW images held in
the channels-last memory format: bf16 compute with float32 parameters and
float32 batch statistics (:class:`~.sync_batch_norm.BatchNorm`, flax's
semantics; :class:`~.sync_batch_norm.SyncBatchNorm` with
``sync_batch_norm=True``), flax's ``"SAME"`` padding (a 3x3 stride-2 conv on
an even input pads (0, 1); see :mod:`.layers`), the global mean pool in the
compute dtype and float32 logits. Submodules carry flax's names in snake
case, so :func:`.layers.from_flax_variables` carries the JAX model's
``params`` and ``batch_stats`` across.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime
from .layers import Conv, Dense, max_pool, reset_flax_defaults
from .sync_batch_norm import BatchNorm, SyncBatchNorm

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "ResNet18", "ResNet34",
           "ResNet50", "ResNet101", "ResNet152"]


class _Block(nn.Module):
    """A residual block: ``convs`` (kernel, stride) pairs, each followed by
    a norm (the last one's scale initialized to 0), ReLU between them, and
    a 1x1 projection of the shortcut where the shape changes."""

    expansion: int
    convs: Sequence[tuple[int, bool]]

    def __init__(self, in_features: int, filters: int, strides: int, norm,
                 dtype, device):
        super().__init__()
        out = filters * self.expansion
        widths = [filters] * (len(self.convs) - 1) + [out]
        ins = [in_features] + widths[:-1]
        self.conv = nn.ModuleList(
            Conv(i, w, (k, k), strides if strided else 1, dtype=dtype,
                 device=device)
            for i, w, (k, strided) in zip(ins, widths, self.convs))
        self.batch_norm = nn.ModuleList(
            norm(w, zero_scale=j == len(widths) - 1)
            for j, w in enumerate(widths))
        if in_features != out or strides != 1:
            self.conv_proj = Conv(in_features, out, (1, 1), strides,
                                  dtype=dtype, device=device)
            self.norm_proj = norm(out)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x):
        y = x
        for j, (conv, norm) in enumerate(zip(self.conv, self.batch_norm)):
            y = norm(conv(y))
            if j < len(self.conv) - 1:
                y = F.relu(y)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (strided) -> 1x1 at 4x the width."""
    expansion = 4
    convs = ((1, False), (3, True), (1, False))


class BasicBlock(_Block):
    """3x3 (strided) -> 3x3."""
    expansion = 1
    convs = ((3, True), (3, False))


class ResNet(nn.Module):
    """NCHW images -> float32 logits (batch, num_classes). ``train()`` mode
    normalizes with batch statistics and updates the running averages;
    ``eval()`` mode reads them. ``sync_batch_norm`` takes the batch
    statistics over the world (the JAX model's ``axis_name``). Built on
    ``device`` (else :func:`runtime.default_device`), with flax's default
    initialization drawn from ``generator``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, sync_batch_norm: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        device = runtime.default_device(device)
        self.dtype = dtype
        norm = partial(SyncBatchNorm if sync_batch_norm else BatchNorm,
                       momentum=0.9, epsilon=1e-5, dtype=dtype, device=device)
        self.conv_init = Conv(3, num_filters, (7, 7), 2,
                              [(3, 3), (3, 3)], dtype=dtype, device=device)
        self.bn_init = norm(num_filters)
        blocks, width = [], num_filters
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(width, num_filters * 2 ** i, strides,
                                        norm, dtype, device))
                width = num_filters * 2 ** i * block_cls.expansion
        # named as flax names them: BottleneckBlock_<i> -> bottleneck_block.i
        self.block_name = ("bottleneck_block" if block_cls is BottleneckBlock
                           else "basic_block")
        self.add_module(self.block_name, nn.ModuleList(blocks))
        self.dense = nn.ModuleList([Dense(width, num_classes, dtype, device)])
        self.to(memory_format=torch.channels_last)
        reset_flax_defaults(self, generator)

    def forward(self, x):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        for block in getattr(self, self.block_name):
            x = block(x)
        x = x.mean((2, 3))
        return self.dense[0](x).float()


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)
