"""The harness driven on the CPU at tiny cells, past its look for a card:
a sound run comes out correct, and a run with the timed path broken
underneath comes out not correct, once for each fault a training cell
can have. The control, the reference computed in fp8 in the program's
place, fails the tiny cells' limits too, and ResNet-50's limits fail a
wrong gradient in a third of the leaves. The tiny cells' limits are their
own (``tiny.TINY_LIMITS``); the real cells' are set from chip readings at
their own sizes (PERF.md)."""

from __future__ import annotations

import types

import pytest
import torch

from perfbench import check, manifest, readings, run
from perfbench.reference import lowp, train as ref_train
from perfbench.tests import tiny

SEED = 2**31 + 11
SECONDS = 1.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def _run(root, cell, **kw):
    return run.execute(root, cell, SEED, SECONDS, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", ["tiny.lm", "tiny.convnet"])
def test_sound_run_is_correct(root, cell):
    line = _run(root, cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny.lm", "tiny.convnet"])
def test_unchanged_state_is_caught(root, cell, monkeypatch):
    for cls in (torch.optim.Adam, torch.optim.SGD):
        monkeypatch.setattr(cls, "step", lambda self, closure=None: None)
    line = _run(root, cell)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] >= 0.99


@pytest.mark.parametrize("cell", ["tiny.lm", "tiny.convnet"])
def test_half_batch_is_caught(root, cell, monkeypatch):
    bench = manifest.Bench(root)
    fam = manifest.family(bench.config(bench.cell(cell)["config"])["family"])
    half = readings.HalfBatch(types.SimpleNamespace(loss=fam.loss))
    monkeypatch.setattr(fam, "loss", half.loss)
    line = _run(root, cell)
    assert not line["correct"], line["checks"]


def test_dp2_sound_and_without_exchange(root, monkeypatch):
    line = _run(root, "tiny.lm.dp2")
    assert line["correct"], line["checks"]
    monkeypatch.setenv("PERFBENCH_TEST_FAULT", "no_exchange")
    line = _run(root, "tiny.lm.dp2",
                rank_module="perfbench.tests.faulty_rank")
    assert not line["correct"]
    assert line["checks"]["grad_gap"]["value"] > \
        line["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.lm", "tiny.convnet"])
def test_control_fails_the_limits(root, cell):
    bench = manifest.Bench(root)
    c = bench.cell(cell)
    cfg, traffic = bench.config(c["config"]), bench.traffic(c["traffic"])
    fam = manifest.family(cfg["family"])
    steps = [[fam.batch(cfg, traffic, SEED, 0, i, "cpu")]
             for i in range(3)]
    ref = ref_train.readings(fam.reference, cfg, SEED, steps, "cpu")
    ctl = ref_train.readings(fam.reference, cfg, SEED, steps, "cpu",
                             precision=lowp.FP8)
    ok, checks = check.judge(check.gaps(ctl, ref), bench.limits(cell))
    assert not ok, checks


def test_a_fault_in_a_third_of_the_leaves_fails_resnet50():
    # a wrong gradient in a third of the leaves (as a wrong BatchNorm
    # backward in the early blocks would give) leaves the median leaf
    # alone; the 90th percentile holds it
    leaves = [f"leaf{i}" for i in range(30)]
    ref = {"losses": [7.0, 7.0, 7.0],
           "grad_norms": dict.fromkeys(leaves, 1.0),
           "change_norms": dict.fromkeys(leaves, 0.1)}
    prog = {"losses": ref["losses"],
            "grad_norms": {n: 1.5 if i < 10 else 1.0
                           for i, n in enumerate(leaves)},
            "change_norms": ref["change_norms"]}
    found = check.gaps(prog, ref)
    assert found["grad_gap_median_leaf"] == 0.0
    assert found["grad_gap_q90"] == pytest.approx(0.5)
    limits = manifest.Bench(tiny.REPO).limits("resnet50.b256")
    ok, checks = check.judge(found, limits)
    assert not ok and checks["grad_gap_q90"]["value"] > \
        checks["grad_gap_q90"]["limit"]
    assert check.judge(check.gaps(ref, ref), limits)[0]
