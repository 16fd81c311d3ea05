#!/usr/bin/env python3
"""The full-width trainer step of two checkouts of the repo, in turns.

``chip_smoke.py``'s trainer (the repo's ``TransformerConfig`` defaults with
``attn_mode="ulysses"``, bf16, 8 x 2048 tokens, ``DistributedOptimizer
(Adam)``, NCCL world 1) runs with the ``horovod_tpu_torch`` of checkout A,
then B, B and A, each turn in a fresh child process: 3 warm-up and 20
timed steps, then one step under ``torch.profiler`` (device busy time, and
the launches and time of copies, casts and fills). Host-bound steps swing
from host to host, so two versions are compared only in turns within one
call. From the repository root, on a host with a card::

    python3 trainer_turns.py <checkout A> <checkout B>

The last line is a JSON list of the four turns.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

WARMUP, TIMED = 3, 20
COPY_WORDS = ("copy", "cat", "fill", "memcpy", "memset")


def turn() -> dict:
    """One turn, in this process: the checkout on ``sys.path`` first."""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from torch.profiler import ProfilerActivity, profile

    hvd.init()
    cfg = TransformerConfig(attn_mode="ulysses")
    model = TransformerLM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(8, 2048))).to(hvd.device())

    def step():
        opt.zero_grad()
        loss = lm_loss(model(tokens), tokens)
        loss.backward()
        opt.step()
        return loss

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        loss = step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TIMED * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))
               and not getattr(e, "is_user_annotation", False)]
    copies = [e for e in kernels
              if any(w in e.key.lower() for w in COPY_WORDS)]
    hvd.shutdown()
    return {"package": os.path.dirname(hvd.__file__),
            "step_ms": step_ms, "loss": loss.item(),
            "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "launches": sum(e.count for e in kernels),
            "copy_ms": sum(e.self_device_time_total for e in copies) / 1e3,
            "copy_launches": sum(e.count for e in copies)}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--turn":
        sys.path.insert(0, argv[1])  # ahead of this script's own checkout
        print(json.dumps(turn()))
        return 0
    if len(argv) != 2:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("trainer_turns: no CUDA device is visible")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    runs = []
    for label, path in zip("ABBA", (argv[0], argv[1], argv[1], argv[0])):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             os.path.abspath(path)], cwd=os.path.abspath(path),
            stdout=subprocess.PIPE, text=True, timeout=600, check=True)
        res = {"checkout": label, "path": path,
               **json.loads(proc.stdout.splitlines()[-1])}
        print(f"[turns] {label} ({path}): step {res['step_ms']:.2f} ms, "
              f"device busy {res['busy_ms']:.2f} ms in {res['launches']} "
              f"launches, copies {res['copy_ms']:.3f} ms x"
              f"{res['copy_launches']}", flush=True)
        runs.append(res)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
