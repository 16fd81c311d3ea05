"""The port's dispatch plan cache (``horovod_tpu_torch/ops/dispatch_cache
.py``) against the JAX package's: the same script of eager collectives,
made from a numpy seed (allreduces of several shapes, dtypes, ops and
scales, grouped allreduces, broadcasts), with knob overrides, a process
set's removal and a small capacity in between, gives the same hits,
misses, invalidations, evictions, negotiation skips and plan count after
every step on both sides (the JAX side on the 8-device CPU mesh, the port
at a gloo world of one), and the same results with the cache on and off.
The plans' contents differ by design (a jitted program there, the
resolved layout and reducer here); their accounting does not."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.ops import dispatch_cache as jdc
from horovod_tpu.utils import envs as jenvs
from horovod_tpu_torch.ops import dispatch_cache as tdc
from horovod_tpu_torch.utils import envs as tenvs

COUNTERS = ("hits", "misses", "invalidations", "evictions",
            "negotiation_skips", "size", "chunked_builds")


@pytest.fixture(scope="module")
def torch_world1():
    os.environ["HVD_DYNAMIC_PROCESS_SETS"] = "1"
    thvd.init(device="cpu")
    yield
    thvd.shutdown()
    del os.environ["HVD_DYNAMIC_PROCESS_SETS"]


@pytest.fixture(autouse=True)
def _fresh(torch_world1):
    jdc.reset()
    tdc.reset()
    yield
    jdc.reset()
    tdc.reset()


def make_script(seed: int, n: int = 30) -> list:
    rng = np.random.default_rng(seed)
    shapes = [(4,), (5,), (2, 3)]
    steps = []
    for _ in range(n):
        r = rng.random()
        shape = shapes[int(rng.integers(len(shapes)))]
        dtype = ["float32", "int32"][int(rng.integers(2))]
        x = rng.integers(-4, 5, size=shape).astype(dtype)
        if r < 0.40:
            op = "Sum" if dtype == "int32" else str(rng.choice(
                ["Sum", "Average", "Max"]))
            post = float(rng.choice([1.0, 0.5])) if op != "Max" else 1.0
            steps.append(("ar", x, op, post))
        elif r < 0.60:
            steps.append(("grouped", [x, x[..., :1].copy()], "Sum", 1.0))
        elif r < 0.75:
            steps.append(("bcast", x, None, None))
        elif r < 0.82:
            steps.append(("gbcast", [x, x.copy()], None, None))
        elif r < 0.88:
            steps.append(("override", int(rng.integers(1, 4)) * 1000, None,
                          None))
        elif r < 0.93:
            steps.append(("capacity", str(int(rng.choice([2, 1024]))), None,
                          None))
        else:
            steps.append(("pset", None, None, None))
    return steps


def run(hvd, dc, envs, to, script, drop_set) -> list:
    """Per step: the cache counters, and the results."""
    rows, outs = [], []
    try:
        for kind, x, op, post in script:
            if kind == "ar":
                outs.append(hvd.allreduce(to(x), op=getattr(hvd, op),
                                          postscale_factor=post))
            elif kind == "grouped":
                outs += hvd.grouped_allreduce([to(a) for a in x],
                                              op=getattr(hvd, op))
            elif kind == "bcast":
                outs.append(hvd.broadcast(to(x), root_rank=0))
            elif kind == "gbcast":
                outs += hvd.grouped_broadcast([to(a) for a in x],
                                              root_rank=0)
            elif kind == "override":
                envs.set_override(envs.FUSION_THRESHOLD, x)
            elif kind == "capacity":
                os.environ["HVD_CACHE_CAPACITY"] = x
            else:
                drop_set()
            s = dc.stats()
            rows.append((kind,) + tuple(s[k] for k in COUNTERS))
    finally:
        envs.clear_override(envs.FUSION_THRESHOLD)
        os.environ.pop("HVD_CACHE_CAPACITY", None)
    return rows, [np.asarray(o) for o in outs]


def _jax_drop_set(hvd):
    """A process set added and removed: its removal invalidates."""
    return lambda: hvd.remove_process_set(hvd.add_process_set([0, 1, 2, 3]))


def _torch_drop_set():
    """A world of one has no set but the global one: the invalidation its
    removal makes (``process_sets.remove_process_set``)."""
    return lambda: tdc.invalidate("process set removed")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_counters_equal_jax_step_by_step(hvd, seed):
    script = make_script(seed)
    want, wout = run(hvd, jdc, jenvs, jnp.asarray, script,
                     _jax_drop_set(hvd))
    got, gout = run(thvd, tdc, tenvs, torch.from_numpy, script,
                    _torch_drop_set())
    assert got == want
    assert len(gout) == len(wout)


def test_results_equal_with_cache_on_and_off(monkeypatch):
    """The plan path and the build-every-call path give the same bits."""
    script = [s for s in make_script(7) if s[0] in ("ar", "grouped",
                                                    "bcast", "gbcast")]
    _, on = run(thvd, tdc, tenvs, torch.from_numpy, script,
                _torch_drop_set())
    tdc.reset()
    monkeypatch.setenv("HVD_CACHE_CAPACITY", "0")
    _, off = run(thvd, tdc, tenvs, torch.from_numpy, script,
                 _torch_drop_set())
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    s = tdc.stats()
    assert s["hits"] == s["misses"] == s["size"] == 0


def test_capacity_zero_disables_like_jax(hvd, monkeypatch):
    monkeypatch.setenv("HVD_CACHE_CAPACITY", "0")
    thvd.allreduce(torch.ones(4), op=thvd.Sum)
    hvd.allreduce(jnp.ones(4), op=hvd.Sum)
    t, j = tdc.stats(), jdc.stats()
    assert {k: t[k] for k in COUNTERS} == {k: j[k] for k in COUNTERS}
    assert t["enabled"] is False and t["size"] == 0


def test_stats_keys_are_jax_keys(hvd):
    assert set(tdc.stats()) == set(jdc.stats())
    assert set(tdc.stats()["hits_by_source"]) == set(
        jdc.stats()["hits_by_source"])


def test_reform_shelving_waits_for_elastic(hvd, monkeypatch):
    """The elastic re-form's shelf, which raised until the port had its
    elastic layer, against the JAX package's on the same script: plans
    shelved, the warm pool restored, the stages grafted at the rebuild,
    and what a knob-override epoch move and a registered process set's
    plan do to them."""
    monkeypatch.setenv("HVD_ELASTIC_WARM", "1")
    sides = ((hvd, jdc, jnp.asarray, jenvs), (thvd, tdc, torch.tensor,
                                                tenvs))
    out = []
    for h, dc, to, envs in sides:
        trace = []
        for name in ("a", "b"):
            h.allreduce(to([1.0, 2.0]), op=h.Sum, name=name)
        h.grouped_allreduce([to([1.0]), to([2.0, 3.0])], op=h.Average,
                            name="g")
        trace.append(dc.shelve_for_reform())
        trace.append(dc.restore_for_reform())
        trace.append(dc.stats()["warm_pool"])
        h.allreduce(to([1.0, 2.0]), op=h.Sum, name="a")
        trace.append((dc.stats()["warm_pool"], dc.stats()["warm_reuses"]))
        trace.append(dc.shelve_for_reform())  # b and g ride along
        envs.set_override("FUSION_THRESHOLD", 1 << 20)  # the epoch moves
        try:
            trace.append(dc.restore_for_reform())
        finally:
            envs.clear_override("FUSION_THRESHOLD")
        trace.append(dc.restore_for_reform())  # the entry went: nothing
        monkeypatch.setenv("HVD_ELASTIC_WARM", "0")
        h.allreduce(to([1.0]), op=h.Sum, name="c")
        trace.append(dc.shelve_for_reform())
        monkeypatch.setenv("HVD_ELASTIC_WARM", "1")
        out.append(trace)
    assert out[1] == out[0]
    assert out[1][:4] == [3, 3, 3, (2, 1)]


def test_fold_knobs_and_drop_match_jax():
    key = ("x", 1)
    assert tdc.fold_knobs("step", key, 5, None) == jdc.fold_knobs(
        "step", key, 5, None)
    plan = tdc.DispatchPlan("l", "A", 4, None, lambda a: a)
    tdc.store(key, plan)
    assert tdc.drop(key) and not tdc.drop(key)
    assert tdc.stats()["invalidations"] == 1


def test_compressor_is_part_of_the_key():
    """The port's ``allreduce`` takes a compressor (the JAX package's
    single allreduce does not): each wire dtype gets its own plan, and
    the fp16 wire's rounding shows in its result."""
    x = torch.tensor([1.0, 1.0 + 2 ** -20])
    plain = thvd.allreduce(x, op=thvd.Sum)
    half = thvd.allreduce(x, op=thvd.Sum, compression=thvd.Compression.fp16)
    assert tdc.stats()["misses"] == 2 and tdc.stats()["size"] == 2
    assert torch.equal(plain, x) and half.tolist() == [1.0, 1.0]
