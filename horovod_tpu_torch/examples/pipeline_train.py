#!/usr/bin/env python
"""Pipeline-parallel language-model training over a dp x pp world: the twin
of the JAX package's ``examples/pipeline_train.py``.

The world's ranks are laid out dp-major: rank ``d * pp + s`` holds stage s
of data-parallel replica d. An LM-shaped model: a replicated embedding,
residual-MLP blocks (``h + tanh(h @ wi) @ wo``) split evenly into one
pipeline stage a rank of the pp group
(``horovod_tpu_torch.parallel.pipeline_apply``, 4 microbatches by default),
and a replicated output head. The pp groups and the dp groups are process
sets that every rank registers in one order. ``DistributedOptimizer(Adam,
process_set=<this rank's dp set>)`` averages every gradient over dp; the
pipeline's own conventions make the stage gradients count once and the
embedding's and head's the same on every stage, with no sync over pp. The
weights and the tokens are the reference's numpy draws (seed 0), so a
first step matches the reference's. The printed loss is the dp average;
the twin raises if it did not fall. Runs on the card unless ``--device
cpu``::

    torchrun --nproc-per-node 4 -m horovod_tpu_torch.examples.pipeline_train --pp 2
    python -m horovod_tpu_torch.examples.pipeline_train --smoke --device cpu --model small

``--model small`` is the reference's (vocab 64, d 32, hidden 128, seq 16, 2
blocks a stage, float32, Adam at 1e-2, 8 sequences a replica). ``full``
(the default) is the repo's widths: vocab 32000, d_model 512, hidden 2048, 4
blocks in all, seq 2048, bf16 compute on float32 parameters, Adam at 1e-3.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import pipeline_apply

# vocab, d_model, seq, blocks (a stage when per_stage, else in all), dtype,
# Adam's learning rate
MODELS = {
    "full": dict(vocab=32000, d=512, seq=2048, blocks=4, per_stage=False,
                 dtype=torch.bfloat16, lr=1e-3),
    "small": dict(vocab=64, d=32, seq=16, blocks=2, per_stage=True,
                  dtype=torch.float32, lr=1e-2),
}
SEQS_PER_REPLICA = 8
N_MICRO = 4  # microbatches of the schedule, as the reference example


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--pp", type=int, default=2,
                        help="pipeline stages (ranks of a pp group)")
    parser.add_argument("--model", choices=tuple(MODELS), default="full")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default=None,
                        help="'cpu' for a gloo world on the host; default "
                             "the card")
    return parser.parse_args(argv)


class Stage(nn.Module):
    """Residual-MLP blocks ``h + tanh(h @ wi) @ wo``, float32 weights,
    computed in ``dtype``."""

    def __init__(self, blocks, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.wi = nn.ParameterList(
            torch.from_numpy(wi).to(device) for wi, _ in blocks)
        self.wo = nn.ParameterList(
            torch.from_numpy(wo).to(device) for _, wo in blocks)

    def forward(self, h):
        h = h.to(self.dtype)
        for wi, wo in zip(self.wi, self.wo):
            h = h + torch.tanh(h @ wi.to(self.dtype)) @ wo.to(self.dtype)
        return h


def init_weights(spec: dict, pp: int, dp: int):
    """The reference's draws, in its order: embedding, each stage's blocks
    (wi, wo), head, then the tokens (8 sequences a replica, seq + 1)."""
    rng = np.random.default_rng(0)
    vocab, d = spec["vocab"], spec["d"]
    per_stage = spec["blocks"] if spec["per_stage"] else spec["blocks"] // pp
    normal = lambda shape, s: (  # noqa: E731
        rng.standard_normal(shape) * s).astype(np.float32)
    embed = normal((vocab, d), 0.1)
    stages = [[(normal((d, 4 * d), 0.05), normal((4 * d, d), 0.05))
               for _ in range(per_stage)] for _ in range(pp)]
    head = normal((d, vocab), 0.1)
    tokens = rng.integers(0, vocab, (SEQS_PER_REPLICA * dp, spec["seq"] + 1))
    return embed, stages, head, tokens


def _group(ps):
    """A process set's group as ``pipeline_apply`` takes it (the world's
    own for the set of all ranks)."""
    return dist.group.WORLD if ps.is_global else ps.group()


def train(args: argparse.Namespace):
    """Train in an initialized world whose process sets may be added
    (``init(process_sets="dynamic")``). Returns the numbers (the dp
    average of each step's loss, each step's time) and the step."""
    dev, n, rank = hvd.device(), hvd.size(), hvd.rank()
    pp = args.pp
    spec = dict(MODELS[args.model])
    if pp < 1 or n % pp:
        raise SystemExit(f"--pp {pp} must be a positive divisor of the "
                         f"{n}-rank world")
    if not spec["per_stage"] and spec["blocks"] % pp:
        raise SystemExit(f"--pp {pp} must divide the {spec['blocks']} blocks")
    if args.smoke:
        spec["seq"] = min(spec["seq"], 16)
    dp = n // pp
    d_rank, s_rank = divmod(rank, pp)
    # every rank registers every set, in one order (dist.new_group)
    pp_sets = [hvd.add_process_set(list(range(r * pp, (r + 1) * pp)))
               for r in range(dp)]
    dp_sets = [hvd.add_process_set(list(range(s, n, pp)))
               for s in range(pp)]
    embed, stages, head, tokens = init_weights(spec, pp, dp)
    dtype = spec["dtype"]
    stage = Stage(stages[s_rank], dtype, dev)
    embed = nn.Parameter(torch.from_numpy(embed).to(dev))
    head = nn.Parameter(torch.from_numpy(head).to(dev))
    params = [embed, *stage.parameters(), head]
    opt = hvd.DistributedOptimizer(torch.optim.Adam(params, lr=spec["lr"]),
                                   process_set=dp_sets[s_rank])
    mine = tokens[d_rank * SEQS_PER_REPLICA:(d_rank + 1) * SEQS_PER_REPLICA]
    x = torch.from_numpy(mine[:, :-1]).to(dev)
    y = torch.from_numpy(mine[:, 1:]).to(dev)
    pp_group = _group(pp_sets[d_rank])

    def step():
        opt.zero_grad()
        h = embed[x].to(dtype)
        h = pipeline_apply(stage, h, pp_group, n_microbatches=N_MICRO)
        logits = (h @ head.to(dtype)).float()
        loss = F.cross_entropy(logits.reshape(-1, spec["vocab"]),
                               y.reshape(-1))
        loss.backward()
        opt.step()
        return loss.detach()

    steps = 8 if args.smoke else args.steps
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = hvd.allreduce(step(), process_set=dp_sets[s_rank])
        losses.append(float(loss))  # waits for the step
        step_s.append(time.perf_counter() - t0)
    return {"model": args.model, "world_size": n, "rank": rank, "pp": pp,
            "dp": dp, "n_micro": N_MICRO, "seq": spec["seq"],
            "tokens_per_replica": SEQS_PER_REPLICA * spec["seq"],
            "losses": losses, "step_s": step_s,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}, step


def main(argv=None) -> dict:
    """Train; raises if the loss did not fall, as the reference asserts."""
    args = parse_args(argv)
    owns = not hvd.is_initialized()
    hvd.init(device=args.device, process_sets="dynamic")
    try:
        res = train(args)[0]
    finally:
        if owns:
            hvd.shutdown()
    first, last = res["losses"][0], res["losses"][-1]
    if res["rank"] == 0:
        later = res["step_s"][1:] or res["step_s"]
        print(f"pp={res['pp']} dp={res['dp']}: loss {first:.4f} -> "
              f"{last:.4f} in {len(res['losses'])} steps "
              f"({1e3 * sum(later) / len(later):.1f} ms a step after the "
              f"first; {res['n_micro']} microbatches, "
              f"{res['tokens_per_replica']} tokens a replica) on "
              f"{res['device']}; {res['model']} model")
    if not last < first:
        raise SystemExit(f"loss did not decrease: {res['losses']}")
    if res["rank"] == 0:
        print("OK")
    return res


if __name__ == "__main__":
    main()
