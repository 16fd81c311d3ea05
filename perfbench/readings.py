"""The readings that the correctness limits are set from: for each seed,
the program's gaps to the reference, and on the first seeds the
control's and the planted faults'.

    python3 -m perfbench.readings --workload <name> --seeds 1,2,3 \\
        [--control-seeds 3] [--faults half_batch,no_exchange] [--out FILE]

Training's readings need no window: each seed builds the program, takes
the checked first steps, frees it, and runs the reference. The control
is the reference in the program's place at the nearest precision below
the configuration's (``reference/lowp.py``: fp8 for bfloat16). The
faults are planted in the program: ``half_batch`` takes each step's loss
over the first half of the rows only, ``no_exchange`` steps every rank
on its own gradient (the optimizer without ``DistributedOptimizer``),
``unchanged_state`` makes the optimizer's step do nothing. A cell on more
than one card runs its ranks under the program's launcher. Rank 0 prints
one JSON line a seed and appends it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAULTS = ("half_batch", "no_exchange", "unchanged_state")


class HalfBatch:
    """A family whose loss leaves out the second half of each batch and
    takes the mean over the rest."""

    def __init__(self, fam):
        self._fam = fam

    def __getattr__(self, name):
        return getattr(self._fam, name)

    def loss(self, model, batch):
        if isinstance(batch, tuple):
            half = batch[0].shape[0] // 2
            return self._fam.loss(model, tuple(t[:half] for t in batch))
        return self._fam.loss(model, batch[:batch.shape[0] // 2])


def program_readings(root, workload: str, seed: int, device: str,
                     fault: str | None = None):
    """The program's checked steps with ``fault`` planted; returns
    (readings, program) with the program closed."""
    import torch
    from .worker import Program
    prog = Program(root, workload, seed, device)
    if fault == "half_batch":
        prog.fam = HalfBatch(prog.fam)
    prog.setup(wrap_optimizer=fault != "no_exchange")
    if fault == "unchanged_state":
        prog.base.step = lambda closure=None: None
    got = prog.check_steps()
    # the world stays: a rank that joined a new one while rank 0 still
    # ran the reference would find no peer to connect to
    prog.close(leave=False)
    if device == "cuda":
        torch.cuda.empty_cache()
    return got, prog


def seed_readings(root, workload: str, seed: int, device: str,
                  control: bool, faults) -> dict | None:
    from . import check
    from .reference import lowp, train as ref_train
    got, prog = program_readings(root, workload, seed, device)
    fam, cfg = prog.fam, prog.cfg
    out = {"seed": seed}
    ref = None
    hvd = prog.hvd
    if prog.rank == 0:
        steps = prog.reference_steps()
        ref = ref_train.readings(fam.reference, cfg, seed, steps, prog.dev)
        out["program"] = check.gaps(got, ref)
        out["losses"] = {"program": got["losses"], "reference": ref["losses"]}
        if control:
            ctl = ref_train.readings(fam.reference, cfg, seed, steps,
                                     prog.dev, precision=lowp.FP8)
            out["control"] = check.gaps(ctl, ref)
    hvd.barrier()  # the other ranks wait for rank 0's reference
    for fault in faults:
        f_got, f_prog = program_readings(root, workload, seed, device, fault)
        if f_prog.rank == 0:
            out[fault] = check.gaps(f_got, ref)
    return out if prog.rank == 0 else None


def run(root, workload: str, seeds, control_seeds: int, faults, device,
        out_path: str | None) -> None:
    import horovod_tpu_torch as hvd
    try:
        _run(root, workload, seeds, control_seeds, faults, device, out_path)
    finally:
        hvd.shutdown()


def _run(root, workload, seeds, control_seeds, faults, device, out_path):
    for k, seed in enumerate(seeds):
        t = time.time()
        res = seed_readings(root, workload, seed, device,
                            k < control_seeds,
                            faults if k < control_seeds else ())
        if res is None:
            continue
        res["seconds"] = time.time() - t
        line = json.dumps(res)
        print(line, flush=True)
        if out_path:
            with open(out_path, "a") as f:
                f.write(line + "\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=str(ROOT),
                   help="the checkout whose BENCHMARK.json names the cell")
    p.add_argument("--rank", action="store_true",
                   help="run as one rank under the launcher")
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    faults = [f for f in a.faults.split(",") if f]
    for f in faults:
        if f not in FAULTS:
            raise SystemExit(f"unknown fault {f!r}; known: {FAULTS}")
    from . import manifest, run as run_mod
    root = Path(a.root)
    run_mod.cache_env(root)
    cell = manifest.Bench(root).cell(a.workload)
    if a.rank or cell["chips"] == 1:
        run(root, a.workload, seeds, a.control_seeds, faults, a.device,
            a.out)
        return 0
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
           str(cell["chips"]), "--", sys.executable, "-m",
           "perfbench.readings", "--rank", *(argv or sys.argv[1:])]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    return subprocess.run(cmd, cwd=root, env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
