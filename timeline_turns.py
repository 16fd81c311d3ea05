#!/usr/bin/env python3
"""What the timeline costs the full-width trainer's step, in turns.

``chip_smoke.py``'s trainer (the repo's ``TransformerConfig`` defaults with
``attn_mode="ulysses"``, bf16, 8 x 2048 tokens, ``DistributedOptimizer
(Adam)``, NCCL world 1) runs in one process in ``PAIRS`` pairs of turns,
the timeline off in one turn of a pair and on in the other, which one goes
first alternating from pair to pair; each turn is ``TIMED`` steps after
one step of warm-up. A step with the timeline on writes a ``STEP``
instant and each gradient bucket's begin and end. Then the host cost of
the records themselves: ``timeline.record`` and an empty ``op_range``,
each ``CALLS`` times. From the repository root, on a host with a card::

    python3 timeline_turns.py

The last line is a JSON object: every turn's mean step time, the medians
and quartiles of the off and on turns, and the record costs in µs.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

PAIRS, TIMED, CALLS = 10, 10, 20000


def main() -> int:
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import timeline
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)

    if not torch.cuda.is_available():
        raise SystemExit("timeline_turns: no CUDA device is visible")
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
        lm_loss(model(tokens), tokens).backward()
        opt.step()

    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        for pair in range(PAIRS):
            for on in ((False, True) if pair % 2 == 0 else (True, False)):
                if on:
                    timeline.start_timeline(os.path.join(tmp, f"{pair}.json"))
                step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TIMED):
                    if on:
                        timeline.record("step", "STEP",
                                        timeline.PHASE_INSTANT)
                    step()
                torch.cuda.synchronize()
                turns.append({"timeline": on, "step_ms": (
                    time.perf_counter() - t0) / TIMED * 1e3})
                if on:
                    timeline.stop_timeline()
        timeline.start_timeline(os.path.join(tmp, "calls.json"))
        t0 = time.perf_counter()
        for _ in range(CALLS):
            timeline.record("x", "A", timeline.PHASE_INSTANT)
        record_us = (time.perf_counter() - t0) / CALLS * 1e6
        t0 = time.perf_counter()
        for _ in range(CALLS):
            with timeline.op_range("y", "ALLREDUCE"):
                pass
        range_us = (time.perf_counter() - t0) / CALLS * 1e6
        timeline.stop_timeline()
    hvd.shutdown()

    def summary(on):
        ms = sorted(t["step_ms"] for t in turns if t["timeline"] == on)
        q = statistics.quantiles(ms, n=4)
        return {"median": statistics.median(ms), "q1": q[0], "q3": q[2],
                "min": ms[0], "max": ms[-1]}

    off, on = summary(False), summary(True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    wins = sum(1 for i in range(0, len(turns), 2)
               if (turns[i]["step_ms"] < turns[i + 1]["step_ms"])
               == (not turns[i]["timeline"]))
    print(f"[timeline] {card}: off median {off['median']:.3f} ms (quartiles "
          f"{off['q1']:.3f}-{off['q3']:.3f}), on median {on['median']:.3f} "
          f"ms ({on['q1']:.3f}-{on['q3']:.3f}); the off turn faster in "
          f"{wins} of {PAIRS} pairs; a record {record_us:.2f} µs, an empty "
          f"op_range {range_us:.2f} µs on the host")
    print(json.dumps({"card": card, "turns": turns, "off": off, "on": on,
                      "off_faster_pairs": wins, "record_us": record_us,
                      "op_range_us": range_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
