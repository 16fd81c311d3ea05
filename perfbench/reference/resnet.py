"""Plain reference of the ``resnet`` family: ResNet v1.5 as the program
computes it, in float32 with TF32 off.

A 7x7 stride-2 stem (padding 3) with BatchNorm and ReLU, a 3x3 stride-2
max pool (padding 1), bottleneck blocks (1x1, 3x3 carrying the stage's
stride, 1x1 at ``expansion`` times the width, each followed by BatchNorm,
ReLU between them and after the residual sum, a strided 1x1 projection
with BatchNorm where the shape changes), a global mean pool and a dense
layer with bias. Convolutions pad as XLA's ``"SAME"`` does: ``total =
max((ceil(n/s) - 1) s + k - n, 0)``, ``total // 2`` before and the rest
after. BatchNorm in training mode normalizes with the batch's biased
variance ``max(E[x^2] - E[x]^2, 0)`` and ``epsilon``. The loss is the
mean cross-entropy over the batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import lowp


def _blocks(cfg):
    """``(prefix, in_width, width, stride)`` of every bottleneck block."""
    out, cin = [], cfg["num_filters"]
    i = 0
    for stage, n in enumerate(cfg["stage_sizes"]):
        width = cfg["num_filters"] * 2 ** stage
        for j in range(n):
            stride = 2 if stage > 0 and j == 0 else 1
            out.append((f"bottleneck_block.{i}.", cin, width, stride))
            cin = width * cfg["expansion"]
            i += 1
    return out


def param_spec(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, named as the program's
    ``state_dict`` names them. Convolutions He-normal over their fan-out
    (std ``sqrt(2 / (out k k))``), the dense layer normal with std
    ``1 / sqrt(fan_in)`` and bias 0, BatchNorm scale 1 and bias 0."""
    e, f0 = cfg["expansion"], cfg["num_filters"]

    def conv(name, cout, cin, k):
        return (name, (cout, cin, k, k),
                ("normal", math.sqrt(2.0 / (cout * k * k))))

    def bn(name, c):
        return [(name + ".weight", (c,), ("ones",)),
                (name + ".bias", (c,), ("zeros",))]

    spec = [conv("conv_init.weight", f0, 3, 7), *bn("bn_init", f0)]
    for pre, cin, w, stride in _blocks(cfg):
        widths = [(cin, w, 1), (w, w, 3), (w, w * e, 1)]
        for j, (ci, co, k) in enumerate(widths):
            spec.append(conv(f"{pre}conv.{j}.weight", co, ci, k))
        for j, (_, co, _) in enumerate(widths):
            spec += bn(f"{pre}batch_norm.{j}", co)
        if cin != w * e or stride != 1:
            spec += [conv(f"{pre}conv_proj.weight", w * e, cin, 1),
                     *bn(f"{pre}norm_proj", w * e)]
    width = f0 * 2 ** (len(cfg["stage_sizes"]) - 1) * e
    spec += [("dense.0.weight", (cfg["num_classes"], width),
              ("normal", 1.0 / math.sqrt(width))),
             ("dense.0.bias", (cfg["num_classes"],), ("zeros",))]
    return spec


def micro_batches(batch):
    """The whole batch at once: BatchNorm couples its rows."""
    return [(batch, 1.0)]


def same_pads(n: int, k: int, s: int) -> tuple:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, precision, pads=None):
    k = w.shape[-1]
    if pads is None:
        pads = [same_pads(n, k, stride) for n in x.shape[2:]]
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        (hlo, hhi), (wlo, whi) = pads
        x, sym = F.pad(x, (wlo, whi, hlo, hhi)), (0, 0)
    return lowp.conv2d(x, w, stride, sym, precision)


def _bn(x, p, name, eps):
    mean = x.mean((0, 2, 3))
    var = (x.square().mean((0, 2, 3)) - mean.square()).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * p[name + ".weight"]
    return ((x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
            + p[name + ".bias"].view(1, -1, 1, 1))


def _block(x, p, pre, stride, eps, precision):
    y = x
    for j, s in enumerate((1, stride, 1)):
        y = _bn(_conv(y, p[f"{pre}conv.{j}.weight"], s, precision),
                p, f"{pre}batch_norm.{j}", eps)
        if j < 2:
            y = F.relu(y)
    if pre + "conv_proj.weight" in p:
        x = _bn(_conv(x, p[pre + "conv_proj.weight"], stride, precision),
                p, pre + "norm_proj", eps)
    return F.relu(x + y)


def logits(p, images, cfg, precision=lowp.FP32):
    eps = cfg["batch_norm_epsilon"]
    x = _conv(images.float(), p["conv_init.weight"], 2, precision,
              pads=[(3, 3), (3, 3)])
    x = F.relu(_bn(x, p, "bn_init", eps))
    x = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=-math.inf), 3, 2)
    for pre, _, _, stride in _blocks(cfg):
        # recomputed in the backward pass: float32 activations of a
        # large batch would not fit beside the optimizer's state otherwise
        x = checkpoint(_block, x, p, pre, stride, eps, precision,
                       use_reentrant=False)
    x = x.mean((2, 3))
    return lowp.linear(x, p["dense.0.weight"], precision) + p["dense.0.bias"]


def loss(p, batch, cfg, precision=lowp.FP32):
    images, labels = batch
    return F.cross_entropy(logits(p, images, cfg, precision), labels)
