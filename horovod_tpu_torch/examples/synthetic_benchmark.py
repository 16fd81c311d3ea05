#!/usr/bin/env python
"""Synthetic throughput benchmark: the twin of the JAX package's
``examples/synthetic_benchmark.py`` (the reference's ResNet-50 on synthetic
ImageNet batches, ``--fp16-allreduce``), with the same flags.

One process per card: ``hvd.init()`` (NCCL) -> ``broadcast_parameters`` ->
forward/backward -> ``DistributedOptimizer(SGD(0.01, momentum=0.9))``, the
same seeded batch every step. ``--model`` also takes VGG16/19 and
InceptionV3 (``--image-size 299``). Runs on the card unless ``--device cpu``
is given::

    python -m horovod_tpu_torch.examples.synthetic_benchmark
    python -m horovod_tpu_torch.examples.synthetic_benchmark --smoke \
        --device cpu
    torchrun --nproc-per-node 4 -m \
        horovod_tpu_torch.examples.synthetic_benchmark
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import models

RESNETS = ("ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152")
DROPOUT_MODELS = ("VGG16", "VGG19", "InceptionV3")  # take a generator


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="ResNet50",
                        choices=RESNETS + DROPOUT_MODELS)
    parser.add_argument("--batch-size", type=int, default=32,
                        help="per-card batch size (reference default)")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-iters", type=int, default=10)
    parser.add_argument("--num-warmup", type=int, default=2)
    parser.add_argument("--fp16-allreduce", action="store_true",
                        help="compress gradients on the wire (reference "
                             "--fp16-allreduce)")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default=None,
                        help="'cpu' for a gloo world on the host; default "
                             "the card")
    args = parser.parse_args(argv)
    if args.smoke:
        args.model, args.image_size = "ResNet18", 32
        args.batch_size, args.num_iters, args.num_warmup = 4, 2, 1
    return args


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(args: argparse.Namespace):
    """Warm up and time the step in an initialized world. Returns the
    numbers, the step (a callable that trains one more step and returns
    its loss) and the step's ``DistributedOptimizer``."""
    dev, n, rank = hvd.device(), hvd.size(), hvd.rank()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    s, b = args.image_size, args.batch_size
    size_kw = {"image_size": s} if args.model.startswith("VGG") else {}
    model = getattr(models, args.model)(
        num_classes=1000, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(0), **size_kw)
    model.train()
    mine = slice(rank * b, (rank + 1) * b)  # this rank's rows of the batch
    images = np.random.default_rng(0).standard_normal(
        (n * b, s, s, 3), dtype=np.float32)[mine]
    labels = np.random.default_rng(1).integers(0, 1000, size=(n * b,))[mine]
    x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2)  # channels-last
    y = torch.from_numpy(labels).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression=compression)
    kw = {}
    if args.model in DROPOUT_MODELS:
        kw["generator"] = torch.Generator(device=dev).manual_seed(1 + rank)

    def step() -> torch.Tensor:
        opt.zero_grad()
        loss = F.cross_entropy(model(x, **kw), y)
        loss.backward()
        opt.step()
        return loss.detach()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [step() for _ in range(args.num_warmup)]
    _sync(dev)
    t0 = time.perf_counter()
    losses += [step() for _ in range(args.num_iters)]
    _sync(dev)
    elapsed = time.perf_counter() - t0
    img_sec = args.num_iters * b * n / elapsed
    result = {
        "model": args.model, "batch_size": b, "image_size": s,
        "world_size": n, "compression": compression.__name__,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "num_params": sum(p.numel() for p in model.parameters()),
        "num_param_tensors": len(list(model.parameters())),
        "img_sec": img_sec, "img_sec_per_device": img_sec / n,
        "step_ms": elapsed / args.num_iters * 1e3,
        "losses": [float(v) for v in losses],
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else None),
    }
    if rank == 0:
        print(f"Model: {args.model}, batch {b}/card, {n} card(s), "
              f"{s}x{s}, {result['compression']} on the wire, on "
              f"{result['device']}")
        print(f"Total img/sec on {n} card(s): {img_sec:.1f} "
              f"({img_sec / n:.1f} per card), step {result['step_ms']:.1f} "
              f"ms, loss {result['losses'][0]:.4f} -> "
              f"{result['losses'][-1]:.4f}")
    return result, step, opt


def main(argv=None) -> dict:
    """Run the benchmark; returns its numbers (see :func:`train`)."""
    args = parse_args(argv)
    owns = not hvd.is_initialized()
    hvd.init(device=args.device)
    try:
        return train(args)[0]
    finally:
        if owns:
            hvd.shutdown()


if __name__ == "__main__":
    main()
