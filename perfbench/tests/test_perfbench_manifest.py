"""BENCHMARK.json against the rules its entries keep, and discovery by name:
a configuration, a traffic mix, a cell and a metric added as files are
taken up with no file that is there edited."""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import pytest

from perfbench import check, manifest
from perfbench.tests import tiny

REPO = tiny.REPO
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|inner|latent|"
                   r"state|proj|head_size|expansion|per_tok|embd")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    assert SPEC["paths"] == ["perfbench"]
    assert len(SPEC["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m) - {"workloads"} <= {
            "name", "unit", "better", "bound", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
               ) == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])


def test_each_cell_reports_enough():
    bench = manifest.Bench(REPO)
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in bench.metrics(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = bench.metrics(w["name"], "per_layer")
        assert layer
        for m in layer:  # each moves a metric its cell reports
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_files_exist_for_every_name():
    bench = manifest.Bench(REPO)
    for c in SPEC["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert (REPO / "perfbench" / "families" / f"{cfg['family']}.py"
                ).exists()
        assert (REPO / "perfbench" / "reference" / f"{cfg['family']}.py"
                ).exists()
    for w in SPEC["workloads"]:
        t = bench.traffic(w["traffic"])
        assert t["ranks"] == w["chips"]
        limits = bench.limits(w["name"])
        assert limits and set(limits) <= set(check.NUMBERS), w["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]).read)


def test_four_chip_cells_and_time_budget():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in (root / "perfbench").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_taken_up_without_edits(tmp_path):
    root = tiny.make(tmp_path)
    # a metric added as a file of its own
    (root / "perfbench" / "metrics" / "tiny_steps.py").write_text(
        "def read(art):\n    return float(art.lead['steps'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "tiny_steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "whole step",
        "moves": "train_tokens_per_s", "workloads": ["tiny.lm"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    before = _digests(REPO)
    after = _digests(root)
    for path, digest in before.items():  # every file there is unchanged
        assert after[path] == digest, path
    bench = manifest.Bench(root)
    assert bench.cell("tiny.lm")["config"] == "gpt2-tiny"
    assert bench.config("gpt2-tiny")["n_layer"] == 2
    assert bench.traffic("lm_tiny")["seq_len"] == 64
    assert bench.limits("tiny.lm")
    names = [m["name"] for m in bench.metrics("tiny.lm", "per_layer")]
    assert "tiny_steps" in names and "mfu.lm" in names
    assert "tiny_steps" not in [
        m["name"] for m in bench.metrics("gpt2xl.b8s1024", "per_layer")]
    art = type("A", (), {"lead": {"steps": 7}})()
    assert bench.reader("tiny_steps").read(art) == 7.0
    with pytest.raises(SystemExit):
        bench.cell("no.such.cell")
