"""VGG family (port of ``horovod_tpu/models/vgg.py``).

NCHW images in the channels-last memory format, bf16 compute with float32
parameters, 3x3 ``"SAME"`` convs with biases (stride 1: symmetric), 2x2
max-pools and three Dense layers with Dropout 0.5 between them. flax
flattens the NHWC feature map, in (H, W, C) order, before the first Dense;
so does
:meth:`VGG.forward` (``x.permute(0, 2, 3, 1)``), so the JAX model's first
Dense kernel imports with no permutation of its rows
(:func:`.layers.from_flax_variables`).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime
from .layers import Conv, Dense, dropout, max_pool, reset_flax_defaults

__all__ = ["VGG", "VGG16", "VGG19", "VGG16_STAGES", "VGG19_STAGES"]

# convs per stage; channels double per stage from 64 to 512
VGG16_STAGES = (2, 2, 3, 3, 3)
VGG19_STAGES = (2, 2, 4, 4, 4)


class VGG(nn.Module):
    """NCHW images -> float32 logits. ``image_size`` fixes the first Dense
    layer's width (flax infers it from the input). In ``train()`` mode the
    Dropout masks (rate ``dropout_rate``, flax's 0.5) come from the
    ``generator`` given to :meth:`forward`."""

    def __init__(self, stage_sizes: Sequence[int] = VGG16_STAGES,
                 num_classes: int = 1000, dtype=torch.bfloat16,
                 classifier_width: int = 4096, image_size: int = 224,
                 dropout_rate: float = 0.5, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = runtime.default_device(device)
        self.dtype, self.stage_sizes = dtype, tuple(stage_sizes)
        self.dropout_rate = dropout_rate
        convs, ch, size = [], 3, image_size
        for i, reps in enumerate(self.stage_sizes):
            out = min(64 * 2 ** i, 512)
            for _ in range(reps):
                convs.append(Conv(ch, out, (3, 3), use_bias=True,
                                  dtype=dtype, device=device))
                ch = out
            size //= 2
        self.conv = nn.ModuleList(convs)
        widths = [ch * size * size, classifier_width, classifier_width,
                  num_classes]
        self.dense = nn.ModuleList(Dense(i, o, dtype, device)
                                   for i, o in zip(widths, widths[1:]))
        self.to(memory_format=torch.channels_last)
        reset_flax_defaults(self, generator)

    def forward(self, x, generator: torch.Generator | None = None):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        convs = iter(self.conv)
        for reps in self.stage_sizes:
            for _ in range(reps):
                x = F.relu(next(convs)(x))
            x = max_pool(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        for dense in self.dense[:-1]:
            x = dropout(F.relu(dense(x)), self.dropout_rate, self.training,
                        generator)
        return self.dense[-1](x).float()


VGG16 = partial(VGG, stage_sizes=VGG16_STAGES)
VGG19 = partial(VGG, stage_sizes=VGG19_STAGES)
