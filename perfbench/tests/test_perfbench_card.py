"""One short run of each cell on the card, through the benchmark's own
command: it exits 0 and prints a correct result line with every metric
the cell reports. Needs an NVIDIA card; skips without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda perfbench/tests
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import manifest
from perfbench.tests import tiny

SPEC = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(cell, trace):
    import torch
    chips = manifest.Bench(tiny.REPO).cell(cell)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA card(s)")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", cell,
         "--seed", str(2**31 + 101), "--seconds", "5", "--trace",
         str(trace)], cwd=tiny.REPO, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in manifest.Bench(tiny.REPO).metrics(cell, kind)}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
