"""The port's step capture (``horovod_tpu_torch/ops/step_capture.py``)
against the JAX package's, in one process: the JAX side on the 8-device
CPU mesh, the port at a gloo world of one, where the replay runs its
plain version (the recorded composition as plain calls; the CUDA Graph is
held to it on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

Each scenario is the JAX package's own (``tests/test_step_capture.py``),
driven on both sides with the same inputs: the ``capture`` block of
``fusion_stats()`` (record, seal, replay, fallback, invalidation counts
and the phase), the step-plan hits and the sealed key (the queue keys'
axis field dropped: the JAX package names a mesh axis there, the port has
none; the dtype names are shared) are equal, and the results are equal
bit for bit after the JAX side's SUM over 8 identical ranks is divided by
8 (integer-valued float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.ops import dispatch_cache as jdc
from horovod_tpu.ops import fusion_cycle as jfc
from horovod_tpu.utils import envs as jenvs
from horovod_tpu_torch.ops import dispatch_cache as tdc
from horovod_tpu_torch.ops import fusion_cycle as tfc
from horovod_tpu_torch.ops import step_capture as tsc
from horovod_tpu_torch.utils import envs as tenvs

N = 8
JAX_KEYS = ("recorded_steps", "captured_flushes", "plan_builds",
            "replayed_steps", "replayed_entries", "fallbacks",
            "invalidations", "uncapturable_steps", "enabled", "state",
            "held_entries", "armed")


@pytest.fixture(scope="module")
def torch_world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


@pytest.fixture(autouse=True)
def _capture_env(monkeypatch, torch_world1):
    monkeypatch.setenv("HVD_CYCLE_TIME", "2000")
    monkeypatch.setenv("HVD_PENDING_CYCLE_TIME", "2000")
    monkeypatch.setenv("HVD_STEP_CAPTURE", "1")
    for m in (jfc, tfc, jdc, tdc):
        m.reset()
    yield
    for m in (jfc, tfc, jdc, tdc):
        m.reset()


class Side:
    def __init__(self, hvd, fc, dc, envs, to, dtype_of, jax):
        self.hvd, self.fc, self.dc, self.envs = hvd, fc, dc, envs
        self.to, self.dtype_of, self.jax = to, dtype_of, jax

    def tensors(self, shapes, mult=1.0, dtype="float32"):
        return [self.to(np.full(shp, mult * (i + 1), np.float32),
                        dtype) for i, shp in enumerate(shapes)]

    def host(self, x) -> np.ndarray:
        a = (x.float().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x.astype(jnp.float32)))
        return a / N if self.jax else a

    def step(self, shapes, mult=1.0, dtype="float32", compression=None):
        """One marked step of per-tensor flushed async SUMs."""
        hvd = self.hvd
        with hvd.step_marker():
            handles = []
            for t in self.tensors(shapes, mult, dtype):
                h = hvd.allreduce_async(t, op=hvd.Sum,
                                        compression=compression)
                h.flush()
                handles.append(h)
            return [self.host(h.synchronize()) for h in handles]

    def stats(self) -> dict:
        st = self.hvd.fusion_stats()["capture"]
        return {k: st[k] for k in JAX_KEYS}

    def key(self):
        key = self.fc.scheduler().capture._last_key
        if key is None:
            return None
        return tuple(((qk[0],) + tuple(qk[3:]), tmpls)
                     for qk, tmpls in key)


def _sides(hvd):
    return [
        Side(hvd, jfc, jdc, jenvs,
             lambda a, dt: jnp.asarray(a, getattr(jnp, dt)), None, True),
        Side(thvd, tfc, tdc, tenvs,
             lambda a, dt: torch.from_numpy(a).to(getattr(torch, dt)),
             None, False),
    ]


def _compress(side):
    return side.hvd.Compression.fp16


def _scenario_record_replay(s):
    out = [s.step([(64,), (33,), (128,)]) for _ in range(4)]
    return out


def _scenario_compression(s):
    return [s.step([(48,), (16,)], compression=_compress(s))
            for _ in range(2)]


def _scenario_mixed(s):
    hvd, out = s.hvd, []
    for _ in range(2):
        with hvd.step_marker():
            g = hvd.grouped_allreduce_async(s.tensors([(8,), (24,)]),
                                            op=hvd.Sum)
            g.flush()
            h = hvd.allreduce_async(s.tensors([(40,)])[0], op=hvd.Sum)
            h.flush()
            out.append([s.host(x) for x in g.synchronize()]
                       + [s.host(h.synchronize())])
    return out


def _scenario_shape_drift(s):
    return [s.step([(64,), (32,)]), s.step([(64,), (32,)]),
            s.step([(64,), (48,)]), s.step([(64,), (48,)]),
            s.step([(64,), (48,)])]


def _scenario_dtype_drift(s):
    return [s.step([(64,)]), s.step([(64,)]),
            s.step([(64,)], dtype="bfloat16")]


def _scenario_extra_tensor(s):
    out = [s.step([(64,)]), s.step([(64,)])]
    hvd = s.hvd
    with hvd.step_marker():
        h1 = hvd.allreduce_async(s.tensors([(64,)])[0], op=hvd.Sum)
        h1.flush()
        h2 = hvd.allreduce_async(s.tensors([(7,)])[0], op=hvd.Sum)
        h2.flush()
        out.append([s.host(h1.synchronize()), s.host(h2.synchronize())])
    return out


def _scenario_mid_step_sync(s):
    hvd, out = s.hvd, []
    for _ in range(2):
        with hvd.step_marker():
            h = hvd.allreduce_async(s.tensors([(64,)])[0], op=hvd.Sum)
            a = s.host(h.synchronize())
            h = hvd.allreduce_async(s.tensors([(32,)])[0], op=hvd.Sum)
            out.append([a, s.host(h.synchronize())])
    return out


def _scenario_abort(s):
    out = [s.step([(64,), (32,)])]
    hvd = s.hvd
    with hvd.step_marker():
        h = hvd.allreduce_async(s.tensors([(64,)])[0], op=hvd.Sum)
        h.flush()
        assert s.fc.scheduler().abort("peer rank 3 failed") >= 1
        with pytest.raises(RuntimeError, match="aborted"):
            h.synchronize()
    out += [s.step([(64,), (32,)]), s.step([(64,), (32,)])]
    return out


def _scenario_knob_override(s):
    out = [s.step([(64,)]), s.step([(64,)])]
    s.envs.set_override(s.envs.FUSION_THRESHOLD, 1 << 22)
    try:
        out += [s.step([(64,)]), s.step([(64,)])]
    finally:
        s.envs.clear_override(s.envs.FUSION_THRESHOLD)
    return out


def _scenario_barrier(s):
    out = [s.step([(64,), (32,)])]
    hvd = s.hvd
    with hvd.step_marker():
        h = hvd.allreduce_async(s.tensors([(64,), (32,)])[0], op=hvd.Sum)
        h.flush()
        hvd.fusion_flush()
        out.append([s.host(h.synchronize())])
    return out


def _scenario_uncapturable(s):
    hvd, out = s.hvd, []
    for _ in range(3):
        with hvd.step_marker():
            h = hvd.allreduce_async(s.tensors([(16,)])[0], op=hvd.Sum)
            h.flush()
            g = hvd.allgather_async(s.tensors([(4,)])[0])
            out.append([s.host(h.synchronize())])
            g.synchronize()
    return out


def _scenario_empty_region(s):
    out = [s.step([(64,), (32,)])]
    with s.hvd.step_marker():
        pass
    out.append(s.step([(64,), (32,)]))
    return out


SCENARIOS = {name[len("_scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("_scenario_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(hvd, name):
    """The capture lifecycle, its counters, the step-plan hits, the sealed
    key and the results, on both sides."""
    got = []
    for side in _sides(hvd):
        results = SCENARIOS[name](side)
        got.append((results, side.stats(),
                    side.dc.stats()["hits_by_source"]["step"], side.key()))
    (jr, js, jh, jk), (tr, ts, th, tk) = got
    if name == "record_replay":
        assert tk is not None and ts["replayed_steps"] == 3
    assert ts == js
    assert th == jh
    assert tk == jk
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("flag", ["cache_off", "capture_off"])
def test_disabled_capture_is_inert_like_jax(hvd, monkeypatch, flag):
    if flag == "cache_off":
        monkeypatch.setenv("HVD_CACHE_CAPACITY", "0")
    else:
        monkeypatch.setenv("HVD_STEP_CAPTURE", "0")
    stats = []
    for side in _sides(hvd):
        side.fc.reset()
        a, b = side.step([(64,)]), side.step([(64,)])
        np.testing.assert_array_equal(a[0], b[0])
        stats.append(side.stats())
    assert stats[1] == stats[0]
    assert stats[1]["recorded_steps"] == stats[1]["replayed_steps"] == 0


def test_two_schedulers_seal_one_key(monkeypatch):
    """Two schedulers fed the same stream seal byte-identical keys (the
    auto names are not part of them)."""
    keys = []
    for _ in range(2):
        sched = tfc.FusionScheduler()
        monkeypatch.setattr(tfc, "_scheduler", sched)
        Side(thvd, tfc, tdc, tenvs,
             lambda a, dt: torch.from_numpy(a), None, False).step(
            [(64,), (32,), (9,)])
        keys.append(repr(sched.capture._last_key))
        sched.stop()
    assert keys[0] == keys[1] != "None"


def test_replay_writes_results_into_the_inputs():
    """The replay's results are its inputs, updated in place (the unpack
    of the graph on the card; its plain version here)."""
    for step in range(3):
        xs = [torch.full((5,), 2.0), torch.full((3,), 4.0)]
        with thvd.step_marker():
            hs = [thvd.allreduce_async(x, op=thvd.Average) for x in xs]
            for h in hs:
                h.flush()
            outs = [h.synchronize() for h in hs]
        if step:
            assert all(o is x for o, x in zip(outs, xs))
        assert [o.tolist() for o in outs] == [[2.0] * 5, [4.0] * 3]
    assert thvd.fusion_stats()["capture"]["replayed_steps"] == 2


def test_integer_postscale_stream_is_uncapturable():
    """An int32 SUM with a postscale comes back float32 (the reference's
    promotion), so it cannot be written in place: the stream stays
    eager."""
    for _ in range(3):
        with thvd.step_marker():
            h = thvd.allreduce_async(torch.ones(4, dtype=torch.int32),
                                     op=thvd.Sum, postscale_factor=0.5)
            h.flush()
            assert h.synchronize().dtype == torch.float32
    st = thvd.fusion_stats()["capture"]
    assert st["uncapturable_steps"] >= 1 and st["replayed_steps"] == 0


def test_optimizer_capture_parity_with_capture_off(monkeypatch):
    """The DistributedOptimizer's buckets under capture: the first pass
    records, the rest replay, and the parameters equal capture off's bit
    for bit (SGD, three buckets, gradients kept in place)."""
    monkeypatch.setenv("HVD_BUCKET_BYTES", "2048")

    def run(on: bool):
        monkeypatch.setenv("HVD_STEP_CAPTURE", "1" if on else "0")
        tfc.reset()
        tdc.reset()
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(16, 24),
                                    torch.nn.Tanh(),
                                    torch.nn.Linear(24, 8))
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        gen = torch.Generator().manual_seed(1)
        for _ in range(4):
            opt.zero_grad(set_to_none=False)
            model(torch.randn(5, 16, generator=gen)).square().sum() \
                .backward()
            opt.step()
        return ([p.detach().clone() for p in model.parameters()],
                thvd.fusion_stats()["capture"])

    off, _ = run(False)
    on, st = run(True)
    assert st["recorded_steps"] == 1 and st["replayed_steps"] == 3
    assert st["fallbacks"] == 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_svc_duplicate_names_seal_uncapturable():
    """A user name repeated within a negotiated step cannot replay in one
    round: it seals uncapturable, as in the JAX package."""
    sched = tfc.FusionScheduler()
    cap = sched.capture

    class _Pset:
        def size(self):
            return 2

    spec = tfc._QueueSpec("allreduce", _Pset(), svc=object())
    sig = (("r", (4,), "float32"),)

    def rec(name):
        return tsc._FlushRecord(spec, [tsc._EntryTemplate(
            ("k",), False, 1, sig, names=(name,))], "bucket")

    assert cap._default_build_plan(("key",), [rec("g"), rec("g")]) is None
    plan = cap._default_build_plan(("key",), [rec("g.0"), rec("g.1")])
    assert isinstance(plan, tsc.StepPlan)
    sched.stop()
