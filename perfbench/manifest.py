"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names its configuration and its traffic;
the configuration's ``file`` gives its sizes and ``family``; the traffic
is ``traffic/<traffic>.json``; the cell's correctness limits are
``limits/<workload>.json``; every metric is ``metrics/<name>.py``; a
family is ``families/<family>.py`` with its reference
``reference/<family>.py``. Nothing here lists a cell, a configuration or
a metric: adding one is adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Bench:
    def __init__(self, root: Path):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self.dir = self.root / self.spec["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"perfbench: no workload named {name!r} in "
                         f"{self.root / 'BENCHMARK.json'}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise SystemExit(f"perfbench: no configuration named {name!r}")

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, workload: str) -> dict:
        path = self.dir / "limits" / f"{workload}.json"
        if not path.exists():
            return {}
        with open(path) as f:
            return json.load(f)["limits"]

    def metrics(self, workload: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries that ``workload``
        reports: those that list it, and those that list no cells."""
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``, loaded by its path (a
        metric's name may hold dots)."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def family(name: str):
    """``families/<name>.py``: builds the program's model (imports the
    program)."""
    return importlib.import_module(f"perfbench.families.{name}")


def reference(name: str):
    """``reference/<name>.py``: the plain reference (no program)."""
    return importlib.import_module(f"perfbench.reference.{name}")
