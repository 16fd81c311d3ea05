#!/usr/bin/env python
"""Mixture-of-Experts with expert parallelism over the world: the twin of
the JAX package's ``examples/moe.py``, with the same task.

One expert lives on each rank. ``horovod_tpu_torch.parallel.moe_alltoall``
routes every rank's tokens to their top-1 expert (capacity-bounded
Switch-style dispatch, ``max(2 * tokens // n, 4)`` slots per pair),
exchanges them over the world with one all-to-all each way, and
gate-combines the outputs. As in the reference, each rank holds one
expert's weights in the example's own layout (a router (d, n), ``w_in``
(d, hidden), ``w_out`` (hidden, d)), made the same on every rank by
``broadcast_parameters``, and ``DistributedOptimizer(Adam)`` averages every
gradient over the world: the reference's ``pmean``. The task: each token's
target is a fixed rotation of itself. The loss is the mean squared error
plus 0.01 times the load-balance loss, averaged over the world; the twin
raises if it did not fall. Runs on the card unless ``--device cpu``::

    torchrun --nproc-per-node 4 -m horovod_tpu_torch.examples.moe
    python -m horovod_tpu_torch.examples.moe --smoke --device cpu

``--model small`` is the reference's (d 32, hidden 128, 64 tokens a rank,
float32). ``full`` (the default) is the repo's widths: d_model 512, expert
hidden 2048, 16384 tokens a rank, bf16 compute on float32 parameters.
``--smoke`` runs 16 tokens a rank for 6 steps.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import moe_alltoall

LR = 3e-3  # Adam, as the reference example
# The models: (d_model, expert hidden, tokens a rank, compute dtype).
MODELS = {
    "full": (512, 2048, 16384, torch.bfloat16),
    "small": (32, 128, 64, torch.float32),
}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--tokens", type=int, default=None,
                        help="tokens a rank (default: the model's)")
    parser.add_argument("--model", choices=tuple(MODELS), default="full")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default=None,
                        help="'cpu' for a gloo world on the host; default "
                             "the card")
    return parser.parse_args(argv)


def moe_layer(params, x, group, capacity, dtype):
    """x: (tokens, d) on this rank. The router in float32, this rank's
    expert FFN in ``dtype``; routing, dispatch, exchange and combine are
    the framework's."""
    logits = x.float() @ params["router"]

    def expert_fn(t):
        h = torch.relu(t.to(dtype) @ params["w_in"].to(dtype))
        return h @ params["w_out"].to(dtype)

    return moe_alltoall(x, logits, expert_fn, group, k=1, capacity=capacity)


def train(args: argparse.Namespace) -> dict:
    """Train in an initialized world; returns the numbers (the world's
    average loss and the time of each step)."""
    dev, n, rank = hvd.device(), hvd.size(), hvd.rank()
    d, hidden, tokens, dtype = MODELS[args.model]
    tokens = 16 if args.smoke else (args.tokens or tokens)
    steps = 6 if args.smoke else args.steps
    capacity = max(2 * tokens // n, 4)
    rng = np.random.default_rng(0)
    x_host = rng.standard_normal((n * tokens, d)).astype(np.float32)
    rot = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    mine = slice(rank * tokens, (rank + 1) * tokens)
    x = torch.from_numpy(x_host[mine]).to(dev)
    y = torch.from_numpy(x_host[mine] @ rot).to(dev)
    g = torch.Generator().manual_seed(rank)  # broadcast makes them agree
    params = {k: torch.nn.Parameter((torch.randn(s, generator=g) * 0.1).to(
        dev)) for k, s in (("router", (d, n)), ("w_in", (d, hidden)),
                           ("w_out", (hidden, d)))}
    hvd.broadcast_parameters(params, root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.Adam(params.values(),
                                                    lr=LR))
    x = x.to(dtype)
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        out, aux = moe_layer(params, x, dist.group.WORLD, capacity, dtype)
        loss = (out.float() - y).pow(2).mean() + 0.01 * aux
        loss.backward()
        opt.step()
        losses.append(float(hvd.allreduce(loss.detach())))
        step_s.append(time.perf_counter() - t0)
    return {"model": args.model, "world_size": n, "rank": rank,
            "tokens_per_rank": tokens, "capacity": capacity, "d_model": d,
            "hidden": hidden, "losses": losses, "step_s": step_s,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}


def main(argv=None) -> dict:
    """Train; raises if the loss did not fall, as the reference asserts."""
    args = parse_args(argv)
    owns = not hvd.is_initialized()
    hvd.init(device=args.device)
    try:
        res = train(args)
    finally:
        if owns:
            hvd.shutdown()
    first, last = res["losses"][0], res["losses"][-1]
    if res["rank"] == 0:
        later = res["step_s"][1:] or res["step_s"]
        print(f"MoE: {res['world_size']} experts over {res['world_size']} "
              f"ranks, {res['tokens_per_rank']} tokens/rank, capacity "
              f"{res['capacity']}, {res['model']} model (d {res['d_model']},"
              f" hidden {res['hidden']}): loss {first:.4f} -> {last:.4f} in "
              f"{len(res['losses'])} steps ({sum(res['step_s']):.1f}s; "
              f"{1e3 * sum(later) / len(later):.1f} ms a step after the "
              f"first) on {res['device']}")
    if not last < first:
        raise SystemExit("loss did not decrease")
    if res["rank"] == 0:
        print("OK")
    return res


if __name__ == "__main__":
    main()
