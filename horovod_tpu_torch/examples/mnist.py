#!/usr/bin/env python
"""MNIST-style training: the twin of the JAX package's ``examples/mnist.py``
(the reference's ``pytorch_mnist.py`` recipe: ``DistributedOptimizer``, the
learning rate scaled by the world size with a warmup, a parameter broadcast
before step 0 and metrics averaged at each epoch's end), with the same
flags.

The dataset is synthetic: 28x28 "digits" are class-placed Gaussian blobs,
enough structure for the loss to fall and the accuracy to rise. Runs on the
card unless ``--device cpu`` is given::

    python -m horovod_tpu_torch.examples.mnist
    python -m horovod_tpu_torch.examples.mnist --smoke --device cpu
    torchrun --nproc-per-node 2 -m horovod_tpu_torch.examples.mnist
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.optim.lr_scheduler import LambdaLR

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.layers import Conv, Dense, reset_flax_defaults


class ConvNet(nn.Module):
    """The reference example's small conv net, float32: two 3x3 stride-2
    ``"SAME"`` convs (28 -> 14 -> 7, each padded (0, 1)) and two Dense
    layers; flax flattens the NHWC feature map, and so does
    :meth:`forward`. Submodules carry flax's names (``conv.0``,
    ``dense.1``)."""

    def __init__(self, device=None, generator: torch.Generator | None = None):
        super().__init__()
        f32 = torch.float32
        self.conv = nn.ModuleList([
            Conv(1, 16, (3, 3), 2, use_bias=True, dtype=f32, device=device),
            Conv(16, 32, (3, 3), 2, use_bias=True, dtype=f32, device=device)])
        self.dense = nn.ModuleList([Dense(7 * 7 * 32, 128, f32, device),
                                    Dense(128, 10, f32, device)])
        reset_flax_defaults(self, generator)

    def forward(self, x):
        for conv in self.conv:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        return self.dense[1](F.relu(self.dense[0](x)))


def synthetic_mnist(n, seed=0):
    """``n`` NHWC float32 images (n, 28, 28, 1) and int64 labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    images = rng.standard_normal((n, 28, 28, 1)).astype(np.float32) * 0.3
    xx, yy = np.meshgrid(np.arange(28), np.arange(28))
    for digit in range(10):
        cx, cy = 4 + 2 * (digit % 5), 6 + 7 * (digit // 5)
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 18)).astype(
            np.float32)
        images[labels == digit, :, :, 0] += blob
    return images, labels


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=64,
                        help="global batch size")
    parser.add_argument("--base-lr", type=float, default=0.01,
                        help="per-worker learning rate (scaled by size)")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny run for CI")
    parser.add_argument("--device", default=None,
                        help="'cpu' for a gloo world on the host; default "
                             "the card")
    args = parser.parse_args(argv)
    if args.smoke:
        args.epochs = 1
    return args


def train(args: argparse.Namespace) -> dict:
    """Train in an initialized world; returns each epoch's averaged
    metrics and this rank's loss at every step. Raises if training made no
    progress."""
    n, dev = hvd.size(), hvd.device()
    batch = max(args.batch_size // n, 1) * n
    images, labels = synthetic_mnist(512 if args.smoke else 8192)
    loader = hvd.data.ShardedArrayLoader(
        np.ascontiguousarray(images.transpose(0, 3, 1, 2)), labels,
        batch_size=batch)
    model = ConvNet(device=dev,
                    generator=torch.Generator().manual_seed(42 + hvd.rank()))
    lr = args.base_lr * n
    # the reference recipe: lr scaled by size, warmed up over an epoch
    schedule = hvd.callbacks.warmup_schedule(
        lr, steps_per_epoch=len(loader), warmup_epochs=1)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9))
    sched = LambdaLR(opt.optimizer, lambda step: schedule(step) / lr)
    # BroadcastGlobalVariablesCallback analog: rank 0's weights everywhere
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    history, step_losses = [], []
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        losses, accs = [], []
        for x, y in loader:
            opt.zero_grad()
            logits = model(x)
            loss = F.cross_entropy(logits, y)
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())
            accs.append((logits.argmax(-1) == y).float().mean())
        # MetricAverageCallback analog: epoch metrics averaged across ranks
        logs = hvd.average_metrics(
            {"loss": torch.stack(losses).mean().item(),
             "accuracy": torch.stack(accs).mean().item()})
        history.append(logs)
        step_losses += [v.item() for v in losses]
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={logs['loss']:.4f} "
                  f"accuracy={logs['accuracy']:.3f}")
    first, last = history[0], history[-1]
    if not (last["loss"] < first["loss"] * 1.001 or last["accuracy"] > 0.2):
        raise RuntimeError(f"training made no progress: {history}")
    return {"epochs": history, "step_losses": step_losses,
            "steps_per_epoch": len(loader),
            "global_batch": batch, "world_size": n}


def main(argv=None) -> dict:
    """Run the example; returns its numbers (see :func:`train`)."""
    args = parse_args(argv)
    owns = not hvd.is_initialized()
    hvd.init(device=args.device)
    try:
        return train(args)
    finally:
        if owns:
            hvd.shutdown()


if __name__ == "__main__":
    main()
