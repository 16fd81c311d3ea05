"""The ``resnet`` family: ``horovod_tpu_torch.models.ResNet`` (v1.5,
bottleneck blocks) trained on image classification.

Builds the program's model from the configuration, draws its weights from
the seed (``frozen/weights.py``, the spec of ``reference/resnet.py``),
feeds synthetic images and labels drawn from the seed on the device, and
counts the model's operations.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.models import ResNet
from horovod_tpu_torch.models.resnet import BottleneckBlock

from ..frozen import weights
from ..reference import resnet as reference

UNIT = "images"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The program's model on ``device`` with the seed's weights."""
    model = ResNet(stage_sizes=cfg["stage_sizes"], block_cls=BottleneckBlock,
                   num_classes=cfg["num_classes"],
                   num_filters=cfg["num_filters"],
                   dtype=DTYPES[cfg["compute_dtype"]], device=device)
    spec = reference.param_spec(cfg)
    params = dict(model.named_parameters())
    got = {n: tuple(p.shape) for n, p in params.items()}
    want = {n: tuple(s) for n, s, _ in spec}
    if got != want:
        raise RuntimeError(f"the program's parameters differ from the "
                           f"spec: {sorted(set(got) ^ set(want))[:8]}")
    weights.fill(params, spec, seed)
    return model


def optimizer(cfg: dict, model) -> torch.optim.Optimizer:
    hp = cfg["optimizer"]
    return torch.optim.SGD(model.parameters(), lr=hp["lr"],
                           momentum=hp["momentum"])


def batch(cfg: dict, traffic: dict, seed: int, rank: int, index: int,
          device):
    """Batch ``index`` of ``rank``: ``batch_per_rank`` standard-normal
    float32 images (NCHW) and uniform labels, from a generator on the
    device seeded by (seed, rank, index)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + rank * 1009 + index) % (1 << 63))
    n, size = traffic["batch_per_rank"], cfg["image_size"]
    images = torch.randn((n, 3, size, size), generator=g, device=device)
    labels = torch.randint(0, cfg["num_classes"], (n,), generator=g,
                           device=device)
    return images, labels


def loss(model, batch_):
    images, labels = batch_
    return torch.nn.functional.cross_entropy(model(images), labels)


def items(traffic: dict) -> int:
    """Images one rank trains on in a step."""
    return traffic["batch_per_rank"]


def _conv_flops(cfg: dict) -> float:
    """Forward operations of one image: 2 per multiply-add of every
    convolution (output size from ``"SAME"`` padding: ceil(n / stride))
    and of the dense layer."""
    size = cfg["image_size"]
    f0, e = cfg["num_filters"], cfg["expansion"]
    n = -(-size // 2)  # the stem, stride 2
    total = 2 * 7 * 7 * 3 * f0 * n * n
    n = -(-n // 2)  # the max pool
    cin = f0
    for stage, blocks in enumerate(cfg["stage_sizes"]):
        w = f0 * 2 ** stage
        for j in range(blocks):
            stride = 2 if stage > 0 and j == 0 else 1
            out = -(-n // stride)
            total += 2 * cin * w * n * n  # 1x1 at the input size
            total += 2 * 9 * w * w * out * out  # 3x3 strided
            total += 2 * w * w * e * out * out  # 1x1 up
            if cin != w * e or stride != 1:
                total += 2 * cin * w * e * out * out
            cin, n = w * e, out
    return total + 2 * cin * cfg["num_classes"]


def flops_per_step(cfg: dict, traffic: dict) -> float:
    """Model operations of one rank's step: 3 x the forward's."""
    return 3.0 * _conv_flops(cfg) * traffic["batch_per_rank"]


def flash_launch(cfg: dict, traffic: dict) -> dict:
    return {}
