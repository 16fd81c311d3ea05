"""The benchmark's command: one cell, one run.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, where no CUDA card is visible or
fewer than the cell asks for, where a rank fails, or where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``horovod_tpu`` is loaded. A
cell on one card runs in this process; a cell on more starts its ranks
through the program's launcher (``worker.py``) and gathers their results
from files under ``TMPDIR``. The last line of standard output is one
JSON object: ``correct``, ``attempted`` and ``failed`` (window steps, and
those whose loss was not finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
for ``correct`` beside its limit, which also close standard error.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "cuda"}
RANKS_TIMEOUT_S = 1100


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path in the checkout; no
    library may load JAX on its own."""
    for var, sub in CACHES.items():
        os.environ[var] = str(root / ".perfbench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def gather(root: Path, workload: str, seed: int, seconds: float,
           trace: bool, device: str, chips: int,
           rank_module: str = "perfbench.worker") -> list:
    """Every rank's result: in this process for one card, else through
    the launcher."""
    if chips == 1:
        from . import worker
        return [worker.run_rank(root, workload, seed, seconds, trace,
                                T_START, device)]
    with tempfile.TemporaryDirectory(prefix="perfbench-") as out:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-np", str(chips), "--", sys.executable, "-m", rank_module,
               "--root", str(root), "--workload", workload,
               "--seed", str(seed), "--seconds", str(seconds),
               "--trace", str(int(trace)), "--t-start", repr(T_START),
               "--device", device, "--out", out]
        # the ranks import this checkout's benchmark and program
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        proc = subprocess.run(cmd, stdout=sys.stderr, cwd=root, env=env,
                              timeout=RANKS_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"perfbench: the ranks failed (launcher exit "
                             f"{proc.returncode})")
        ranks = []
        for r in range(chips):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        return ranks


def execute(root: Path, workload: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda",
            rank_module: str = "perfbench.worker") -> dict:
    """Run the cell and build its result line (a dict)."""
    from . import check, manifest, readers
    from .frozen import imports, stats
    bench = manifest.Bench(root)
    cell = bench.cell(workload)
    cache_env(root)
    ranks = gather(root, workload, seed, seconds, trace, device,
                   cell["chips"], rank_module)
    art = readers.Artefacts(cell, bench.config(cell["config"]),
                            bench.traffic(cell["traffic"]), ranks)
    lead = art.lead
    found = sorted({m for r in ranks for m in r["forbidden"]}
                   | set(imports.forbidden_loaded()))
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
    gaps = check.gaps(lead["program"], lead["reference"])
    correct, checks = check.judge(gaps, bench.limits(workload))
    failed = sum(r["nonfinite"] for r in ranks)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(workload, kind):
        value = bench.reader(m["name"]).read(art)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": lead["platform"], "kind": lead["device_name"],
                   "count": lead["world"],
                   "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    line = {"correct": correct and failed == 0, "attempted": lead["steps"],
            "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        bw = readers.busy_window_s(art)
        if bw is not None:
            device_info["busy_s"], device_info["window_s"] = bw
        bd = readers.breakdown(art)
        if bd is not None:
            line["breakdown"] = bd
    line["diagnosis"] = gaps
    line["host"] = lead["host"]
    ms = lead["step_ms"]
    line["steps_ms"] = {"first": ms[0], "median": stats.median(ms),
                        "p10": stats.percentile(ms, 10),
                        "p90": stats.percentile(ms, 90), "last": ms[-1],
                        "first_half_median": stats.median(ms[:len(ms) // 2]),
                        "second_half_median": stats.median(
                            ms[len(ms) // 2:])}
    line["checks"] = checks  # last: the numbers compared, with limits
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from . import manifest
    from .frozen import imports
    cell = manifest.Bench(ROOT).cell(a.workload)
    imports.check("start-up")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {a.workload} needs {cell['chips']} CUDA card(s), "
              f"{n} visible", file=sys.stderr)
        return 2
    line = execute(ROOT, a.workload, a.seed, a.seconds, bool(a.trace))
    imports.check("after the window")
    card = _power_limit()
    for name, m in line["metrics"].items():
        print(f"perfbench: {name} = {m['value']!r} {m['unit']}"
              + (f" (card: {card})" if "mfu" in name else ""),
              file=sys.stderr)
    print(f"perfbench: host in the window: {json.dumps(line['host'])}",
          file=sys.stderr)
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
