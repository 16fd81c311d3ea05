#!/usr/bin/env python
"""Long-context LM training with sequence parallelism: the twin of the JAX
package's ``examples/long_context_lm.py``, with the same flags.

The sequence is split over the ranks of the world, one block per rank, and
attention runs as ring attention (``--attn ring``), its causal
load-balanced zigzag schedule (``ring_zigzag``) or Ulysses (``ulysses``)
over that sequence group. Each step: forward on this rank's block ->
backward -> ``DistributedOptimizer(Adam)``, which averages the gradients
over the world: the reference's ``pmean`` over the sequence axis. The
printed loss is the world's average of the block losses. Runs on the card
unless ``--device cpu`` is given::

    python -m horovod_tpu_torch.examples.long_context_lm --attn ring_zigzag
    python -m horovod_tpu_torch.examples.long_context_lm --smoke --device cpu
    torchrun --nproc-per-node 4 -m \\
        horovod_tpu_torch.examples.long_context_lm --seq-len 65536

``--model`` picks the widths, the same on every device. ``full`` (the
default) is the repo's ``TransformerConfig`` defaults (vocab 32000, 4
layers, 8 heads of 64, d_ff 2048, bf16 compute) with Adam at 3e-4: the
card's kernels take head dims of 64 and 128 only, and with one sequence a
step and no warm-up, 1e-3 made the loss rise again at the fifth step over
16384 tokens on an H100 (``--lr`` sets another rate). ``small`` is the
reference example's model (vocab 64, 2 layers, 8 heads of 8, float32,
Adam at 1e-2), whose head dim only the plain versions take: it runs on
the CPU alone.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss
from horovod_tpu_torch.ops import flash

# The models: (TransformerConfig widths, Adam's learning rate).
MODELS = {
    "full": (dict(dtype=torch.bfloat16), 3e-4),
    "small": (dict(vocab_size=64, num_layers=2, num_heads=8, d_model=64,
                   d_ff=128, dtype=torch.float32), 1e-2),
}


def synthetic_tokens(n_seqs, seq_len, vocab, seed=0):
    """Deterministic structure (arithmetic progressions mod vocab) so the
    LM has something learnable at every context position."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(n_seqs, 1))
    step = rng.integers(1, 7, size=(n_seqs, 1))
    pos = np.arange(seq_len)[None, :]
    return ((start + step * pos) % vocab).astype(np.int64)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--attn", choices=("ring", "ring_zigzag", "ulysses"),
                        default="ring")
    parser.add_argument("--seq-len", type=int, default=None,
                        help="total context length (default 64 tokens a "
                             "rank)")
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--model", choices=tuple(MODELS), default="full",
                        help="'full': the repo's TransformerConfig defaults "
                             "in bf16; 'small': the reference example's "
                             "model (head dim 8: the CPU only)")
    parser.add_argument("--lr", type=float, default=None,
                        help="Adam's learning rate (default: the model's)")
    parser.add_argument("--device", default=None,
                        help="'cpu' for a gloo world on the host; default "
                             "the card")
    return parser.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(args: argparse.Namespace, keep_first_logits: bool = False):
    """Train in an initialized world. Returns the numbers (the world's
    average loss, the time and the kernel launches of each step, and with
    ``keep_first_logits`` this rank's logits of the first step, copied to
    the host) and the step: a callable that trains one more step and
    returns its logits and this rank's loss."""
    dev, n, rank = hvd.device(), hvd.size(), hvd.rank()
    seq = args.seq_len or (16 if args.smoke else 64) * n
    if seq % n:
        raise SystemExit(f"--seq-len must divide by {n} ranks")
    block = seq // n
    steps = 5 if args.smoke else args.steps
    widths, lr = MODELS[args.model]
    lr = args.lr or lr
    cfg = TransformerConfig(**widths, max_seq_len=seq, attn_mode=args.attn)
    model = TransformerLM(cfg, device=dev, seq_group=dist.group.WORLD)
    model.reset_parameters(torch.Generator().manual_seed(0))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=lr))
    tokens = synthetic_tokens(args.batch, seq, cfg.vocab_size)
    t = torch.from_numpy(tokens[:, rank * block:(rank + 1) * block]).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    def step():
        opt.zero_grad()
        logits = model(t)
        loss = lm_loss(logits, t)
        loss.backward()
        opt.step()
        return logits.detach(), loss.detach()

    losses, step_s, launches, first_logits = [], [], [], None
    for i in range(steps):
        before = dict(flash.launches)
        t0 = time.perf_counter()
        logits, loss = step()
        losses.append(hvd.allreduce(loss))
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        launches.append({k: flash.launches[k] - before[k] for k in before})
        if keep_first_logits and i == 0:  # held on the host
            first_logits = logits.cpu()
        del logits, loss
    result = {
        "attn": args.attn, "model": args.model, "world_size": n, "rank": rank, "seq_len": seq,
        "tokens_per_rank": block, "batch": args.batch, "lr": lr,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "num_params": sum(p.numel() for p in model.parameters()),
        "losses": [float(v) for v in losses], "step_s": step_s,
        "launches_per_step": launches,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else None),
    }
    if keep_first_logits:
        result["first_logits"] = first_logits
    return result, step


def main(argv=None) -> dict:
    """Train; returns the numbers (see :func:`train`). Raises if the loss
    did not fall, as the reference does."""
    args = parse_args(argv)
    owns = not hvd.is_initialized()
    hvd.init(device=args.device)
    try:
        res = train(args)[0]
    finally:
        if owns:
            hvd.shutdown()
    first, last = res["losses"][0], res["losses"][-1]
    if res["rank"] == 0:
        later = res["step_s"][1:] or res["step_s"]
        print(f"{res['attn']} attention over {res['world_size']} ranks, "
              f"seq={res['seq_len']} ({res['tokens_per_rank']} tokens/rank):"
              f" loss {first:.3f} -> {last:.3f} in {len(res['losses'])} "
              f"steps ({sum(res['step_s']):.1f}s; "
              f"{1e3 * sum(later) / len(later):.1f} ms a step after the "
              f"first) on {res['device']}; {res['model']} model, "
              f"{res['num_params'] / 1e6:.1f} M params, Adam at "
              f"{res['lr']:g}")
    if not last < first:
        raise SystemExit("loss did not decrease")
    if res["rank"] == 0:
        print("OK")
    return res


if __name__ == "__main__":
    main()
