"""Inception V3 (port of ``horovod_tpu/models/inception.py``).

NCHW images (299x299 native; any size from 75x75 up) in the channels-last
memory format, bf16 compute with float32 parameters and batch statistics
(BatchNorm epsilon 1e-3, flax's semantics). ``"VALID"`` max-pools have no
padding; the 3x3 average pool is ``"SAME"`` with the padding counted in the
mean. Each block keeps its :class:`ConvBN`s in a list ordered as flax names
them, which is the order flax *constructs* them: in ``c(64, (5, 5))(c(48,
(1, 1))(x))`` the 5x5 is built, and named, before the 1x1 that feeds it. So
:func:`.layers.from_flax_variables` maps ``ConvBN_<j>`` to ``conv_bn.<j>``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime
from .layers import (Conv, Dense, avg_pool_same, dropout, max_pool,
                     reset_flax_defaults)
from .sync_batch_norm import BatchNorm

__all__ = ["ConvBN", "InceptionA", "InceptionB", "InceptionC", "InceptionV3",
           "ReductionA", "ReductionB"]


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm (momentum 0.9, epsilon 1e-3) -> ReLU."""

    def __init__(self, in_features: int, features: int, kernel=(3, 3),
                 strides=(1, 1), padding="SAME", dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.conv = nn.ModuleList([Conv(in_features, features, kernel,
                                        strides, padding, dtype=dtype,
                                        device=device)])
        self.batch_norm = nn.ModuleList([BatchNorm(
            features, momentum=0.9, epsilon=1e-3, dtype=dtype,
            device=device)])

    def forward(self, x):
        return F.relu(self.batch_norm[0](self.conv[0](x)))


class _Block(nn.Module):
    """A block of :class:`ConvBN`s, built from ``(in, out, kernel[,
    strides, padding])`` specs in flax's naming order."""

    def __init__(self, specs, dtype, device):
        super().__init__()
        self.conv_bn = nn.ModuleList(
            ConvBN(*spec, dtype=dtype, device=device)
            for spec in specs)

    def chain(self, x, *idxs):
        """Apply ``conv_bn[i]`` for each index in turn."""
        for i in idxs:
            x = self.conv_bn[i](x)
        return x


class InceptionA(_Block):
    def __init__(self, in_features: int, pool_features: int,
                 dtype=torch.bfloat16, device=None):
        c = in_features
        super().__init__([(c, 64, 1), (48, 64, 5), (c, 48, 1),
                          (96, 96, 3), (64, 96, 3), (c, 64, 1),
                          (c, pool_features, 1)], dtype, device)
        self.out_features = 224 + pool_features

    def forward(self, x):
        return torch.cat([self.chain(x, 0), self.chain(x, 2, 1),
                          self.chain(x, 5, 4, 3),
                          self.chain(avg_pool_same(x), 6)], 1)


class ReductionA(_Block):
    def __init__(self, in_features: int, dtype=torch.bfloat16, device=None):
        c = in_features
        super().__init__([(c, 384, 3, 2, "VALID"), (96, 96, 3, 2, "VALID"),
                          (64, 96, 3), (c, 64, 1)], dtype, device)
        self.out_features = 384 + 96 + c

    def forward(self, x):
        return torch.cat([self.chain(x, 0), self.chain(x, 3, 2, 1),
                          max_pool(x, 3, 2)], 1)


class InceptionB(_Block):
    """Factorized 7x7 branches (the V3 signature block)."""

    def __init__(self, in_features: int, channels_7x7: int,
                 dtype=torch.bfloat16, device=None):
        c, cc = in_features, channels_7x7
        super().__init__([(c, 192, 1), (cc, 192, (7, 1)), (cc, cc, (1, 7)),
                          (c, cc, 1), (c, cc, 1), (cc, cc, (7, 1)),
                          (cc, cc, (1, 7)), (cc, cc, (7, 1)),
                          (cc, 192, (1, 7)), (c, 192, 1)], dtype, device)
        self.out_features = 4 * 192

    def forward(self, x):
        return torch.cat([self.chain(x, 0), self.chain(x, 3, 2, 1),
                          self.chain(x, 4, 5, 6, 7, 8),
                          self.chain(avg_pool_same(x), 9)], 1)


class ReductionB(_Block):
    def __init__(self, in_features: int, dtype=torch.bfloat16, device=None):
        c = in_features
        super().__init__([(192, 320, 3, 2, "VALID"), (c, 192, 1),
                          (c, 192, 1), (192, 192, (1, 7)),
                          (192, 192, (7, 1)), (192, 192, 3, 2, "VALID")],
                         dtype, device)
        self.out_features = 320 + 192 + c

    def forward(self, x):
        return torch.cat([self.chain(x, 1, 0), self.chain(x, 2, 3, 4, 5),
                          max_pool(x, 3, 2)], 1)


class InceptionC(_Block):
    """Expanded-filter-bank output blocks (8x8 grid)."""

    def __init__(self, in_features: int, dtype=torch.bfloat16, device=None):
        c = in_features
        super().__init__([(c, 320, 1), (c, 384, 1), (384, 384, (1, 3)),
                          (384, 384, (3, 1)), (c, 448, 1), (448, 384, 3),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (c, 192, 1)], dtype, device)
        self.out_features = 320 + 4 * 384 + 192

    def forward(self, x):
        b2 = self.chain(x, 1)
        b3 = self.chain(x, 4, 5)
        return torch.cat([self.chain(x, 0), self.chain(b2, 2),
                          self.chain(b2, 3), self.chain(b3, 6),
                          self.chain(b3, 7),
                          self.chain(avg_pool_same(x), 8)], 1)


class InceptionV3(nn.Module):
    """NCHW images -> float32 logits. ``train()`` mode normalizes with batch
    statistics and applies Dropout (rate ``dropout_rate``, flax's 0.5)
    before the classifier, with masks from the ``generator`` given to
    :meth:`forward`."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 dropout_rate: float = 0.5, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = runtime.default_device(device)
        self.dtype, self.dropout_rate = dtype, dropout_rate
        kw = dict(dtype=dtype, device=device)
        self.conv_bn = nn.ModuleList([
            ConvBN(3, 32, 3, 2, "VALID", **kw),
            ConvBN(32, 32, 3, padding="VALID", **kw),
            ConvBN(32, 64, 3, **kw),
            ConvBN(64, 80, 1, padding="VALID", **kw),
            ConvBN(80, 192, 3, padding="VALID", **kw)])
        blocks, c = [], 192
        for pool_features in (32, 64, 64):
            blocks.append(InceptionA(c, pool_features, **kw))
            c = blocks[-1].out_features
        self.inception_a = nn.ModuleList(blocks)
        self.reduction_a = nn.ModuleList([ReductionA(c, **kw)])
        c = self.reduction_a[0].out_features
        self.inception_b = nn.ModuleList(InceptionB(c, cc, **kw)
                                         for cc in (128, 160, 160, 192))
        self.reduction_b = nn.ModuleList([ReductionB(c, **kw)])
        c = self.reduction_b[0].out_features
        self.inception_c = nn.ModuleList([InceptionC(c, **kw)])
        c = self.inception_c[0].out_features
        self.inception_c.append(InceptionC(c, **kw))
        self.dense = nn.ModuleList([Dense(c, num_classes, dtype, device)])
        self.to(memory_format=torch.channels_last)
        reset_flax_defaults(self, generator)

    def forward(self, x, generator: torch.Generator | None = None):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        stem = self.conv_bn
        x = stem[2](stem[1](stem[0](x)))
        x = max_pool(x, 3, 2)
        x = max_pool(stem[4](stem[3](x)), 3, 2)
        for block in (*self.inception_a, *self.reduction_a,
                      *self.inception_b, *self.reduction_b,
                      *self.inception_c):
            x = block(x)
        x = dropout(x.mean((2, 3)), self.dropout_rate, self.training,
                    generator)
        return self.dense[0](x).float()
