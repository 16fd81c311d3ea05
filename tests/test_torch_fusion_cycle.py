"""The port's fusion cycle (``horovod_tpu_torch/ops/fusion_cycle.py``)
against the JAX package's, in one process: the JAX side on the 8-device
CPU mesh, the port at a gloo world of one.

Both sides run the same submission script, made from a numpy seed: async
allreduces (single and grouped, SUM and AVERAGE, two dtypes), broadcasts
and allgathers, each followed or not by a trigger (``synchronize``,
``poll``, a handle's ``flush``, ``barrier``). Compared exactly: the flush
batches (trigger, queue kind and the entries' names, auto names
renumbered from their first), the scheduler's counters, and the results.
Every input is every rank's own (a raw array on the JAX side), its
values integer-valued float32, so an AVERAGE over 8 identical ranks and
one over a single rank agree bit for bit.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.ops import dispatch_cache as jdc
from horovod_tpu.ops import fusion_cycle as jfc
from horovod_tpu_torch.ops import dispatch_cache as tdc
from horovod_tpu_torch.ops import fusion_cycle as tfc

LONG_CYCLE_MS = "3600000"  # an hour: no test outlasts it, so the timer
# fires only where a test sets its own cycle time


@pytest.fixture(scope="module")
def torch_world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, torch_world1):
    monkeypatch.setenv("HVD_CYCLE_TIME", LONG_CYCLE_MS)
    monkeypatch.setenv("HVD_PENDING_CYCLE_TIME", LONG_CYCLE_MS)
    for m in (jfc, tfc, jdc, tdc):
        m.reset()
    yield
    for m in (jfc, tfc, jdc, tdc):
        m.reset()


class _Side:
    """One package behind one interface: its API, its scheduler module and
    the conversion of a numpy input."""

    def __init__(self, hvd, fc, dc, to):
        self.hvd, self.fc, self.dc, self.to = hvd, fc, dc, to

    def np(self, x):
        return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _sides(hvd):
    return [_Side(hvd, jfc, jdc, jnp.asarray),
            _Side(thvd, tfc, tdc, torch.from_numpy)]


def make_script(seed: int, n_ops: int = 24) -> list:
    """A submission script: ``(op, args)`` steps, from ``seed``."""
    rng = np.random.default_rng(seed)
    script, live = [], 0
    for _ in range(n_ops):
        kind = rng.choice(["ar", "ar", "grouped", "bcast", "gather"])
        shape = tuple(int(d) for d in rng.integers(1, 6, size=rng.integers(
            1, 3)))
        dtype = rng.choice(["float32", "int32"])
        op = rng.choice(["Sum", "Average"]) if dtype == "float32" else "Sum"
        x = rng.integers(-8, 9, size=shape).astype(dtype)
        if kind == "grouped":
            xs = [x, rng.integers(-8, 9, size=(3,)).astype(dtype)]
            script.append(("grouped", xs, op))
        elif kind == "bcast":
            script.append(("bcast", x, None))
        elif kind == "gather":
            script.append(("gather", x, None))
        else:
            script.append(("ar", x, op))
        live += 1
        trig = rng.choice(["none", "none", "sync", "poll", "flush",
                           "barrier"])
        if trig != "none":
            script.append((trig, int(rng.integers(0, live)), None))
    return script


def run_script(side: _Side, script) -> dict:
    """Drive ``script`` on one side; the flush history, the counters and
    every result."""
    hvd = side.hvd
    handles, results = [], {}
    for step, arg, op in script:
        if step == "ar":
            handles.append(hvd.allreduce_async(side.to(arg),
                                               op=getattr(hvd, op)))
        elif step == "grouped":
            handles.append(hvd.grouped_allreduce_async(
                [side.to(a) for a in arg], op=getattr(hvd, op)))
        elif step == "bcast":
            handles.append(hvd.broadcast_async(side.to(arg), 0))
        elif step == "gather":
            handles.append(hvd.allgather_async(side.to(arg)))
        elif step == "sync":
            hvd.synchronize(handles[arg])
        elif step == "poll":
            deadline = time.monotonic() + 10
            while not hvd.poll(handles[arg]):
                assert time.monotonic() < deadline
        elif step == "flush":
            handles[arg].flush()
        else:
            hvd.barrier()
    for i, h in enumerate(handles):
        out = hvd.synchronize(h)
        results[i] = ([side.np(o) for o in out] if isinstance(out, list)
                      else side.np(out))
    sched = side.fc.scheduler()
    stats = sched.stats()
    return {"history": _normalize(sched.flush_history), "stats": stats,
            "results": results, "plans": side.dc.stats()}


def _normalize(history) -> list:
    """(trigger, queue kind, names): each auto-name counter renumbered from
    its first appearance, so both packages' process-wide counters compare."""
    first: dict = {}
    out = []
    for trigger, key, names in history:
        norm = []
        for n in names:
            if n is None:
                norm.append(None)
                continue
            base, _, num = n.rpartition(".")
            if not num.isdigit():
                base, num = n, "0"
            head = base.split(".")[0]
            if head in ("q_grouped_allreduce",):  # name.i of a group
                gbase, _, gnum = base.rpartition(".")
                first.setdefault(gbase, int(gnum))
                norm.append(f"{gbase}.{int(gnum) - first[gbase]}.{num}")
                continue
            first.setdefault(base, int(num))
            norm.append(f"{base}.{int(num) - first[base]}")
        out.append((trigger, key[0], tuple(norm)))
    return out


STAT_KEYS = ("enqueued_tensors", "enqueued_bytes", "pending_tensors",
             "pending_bytes", "flushes", "flushed_tensors", "flushed_bytes",
             "dispatches", "wire_programs", "coalesce_ratio")


def _check_results(ours, theirs):
    assert ours.keys() == theirs.keys()
    for i in ours:
        a, b = ours[i], theirs[i]
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=str(i))
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(i))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_script_flushes_counters_and_results_equal_jax(hvd, seed):
    """The same script: the same flush batches in the same order, the
    same counters, the same results (AVERAGE over identical ranks is the
    input itself; a SUM over 8 of them is 8 times the port's); allgather
    results hold every rank's rows on the JAX side, one's on the port."""
    script = make_script(seed)
    jax_side, torch_side = _sides(hvd)
    want = run_script(jax_side, script)
    got = run_script(torch_side, script)
    assert got["history"] == want["history"]
    for k in STAT_KEYS:
        assert got["stats"][k] == want["stats"][k], k
    kinds = [s for s in script if s[0] in ("ar", "grouped", "bcast",
                                           "gather")]
    for i, (kind, arg, op) in enumerate(kinds):
        g, w = got["results"][i], want["results"][i]
        if kind == "gather":
            np.testing.assert_array_equal(w, np.concatenate([g] * 8))
        elif kind == "bcast" or op == "Average":
            _check_results({i: g}, {i: w})
        else:
            scale = lambda x: x * 8  # noqa: E731
            _check_results({i: [scale(x) for x in g] if isinstance(g, list)
                            else scale(g)}, {i: w})


@pytest.mark.parametrize("trigger", ["threshold", "backpressure"])
def test_capacity_triggers_equal_jax(hvd, monkeypatch, trigger):
    """Four 32-byte submissions: the threshold trips at the fourth, the
    backpressure cap at the fourth; both sides drain the same batches."""
    if trigger == "threshold":
        monkeypatch.setenv("HVD_FUSION_THRESHOLD", "100")
    else:
        monkeypatch.setenv("HVD_FUSION_THRESHOLD", str(1 << 30))
        monkeypatch.setenv("HVD_FUSION_MAX_PENDING", "100")
    out = []
    for side in _sides(hvd):
        hs = [side.hvd.allreduce_async(side.to(np.full(8, i, np.float32)),
                                       op=side.hvd.Average)
              for i in range(4)]
        res = [side.np(side.hvd.synchronize(h)) for h in hs]
        out.append((_normalize(side.fc.scheduler().flush_history),
                    side.fc.scheduler().stats()["flushes"], res))
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    assert out[1][1][trigger] >= 1
    _check_results(dict(enumerate(out[1][2])), dict(enumerate(out[0][2])))


def test_cycle_timer_flushes_a_single_rank_queue(monkeypatch):
    """The timer flushes a queue whose set is one rank (no peer whose
    drains could differ) after ``HVD_CYCLE_TIME``."""
    monkeypatch.setenv("HVD_CYCLE_TIME", "30")
    h = thvd.allreduce_async(torch.ones(4), op=thvd.Sum)
    assert h._entry.event.wait(5.0)
    assert thvd.fusion_stats()["flushes"]["cycle"] >= 1
    assert thvd.synchronize(h).tolist() == [1.0] * 4


def test_abort_fails_pending_entries_like_jax(hvd):
    """Both: an aborted entry polls True and raises at synchronize."""
    for side in _sides(hvd):
        h = side.hvd.allreduce_async(side.to(np.ones(3, np.float32)))
        assert side.fc.scheduler().abort("test abort") == 1
        assert side.hvd.poll(h) is True
        with pytest.raises(RuntimeError, match="test abort"):
            side.hvd.synchronize(h)


def test_cycle_off_issues_at_once():
    """``HVD_CYCLE_TIME=0``: nothing queues."""
    import os
    os.environ["HVD_CYCLE_TIME"] = "0"
    try:
        h = thvd.allreduce_async(torch.ones(2), op=thvd.Sum)
        assert not hasattr(h, "_entry")
        assert thvd.fusion_stats()["enqueued_tensors"] == 0
        assert h.synchronize().tolist() == [1.0, 1.0]
    finally:
        os.environ["HVD_CYCLE_TIME"] = LONG_CYCLE_MS


@pytest.mark.parametrize("slots", ["1", "2"])
def test_pipeline_block_equal_jax(hvd, monkeypatch, slots):
    """Synchronous (1 slot) and pipelined (2) executors: the pipeline
    block's submitted and executed counts agree after the same stream."""
    monkeypatch.setenv("HVD_MAX_INFLIGHT_FLUSHES", slots)
    got = []
    for side in _sides(hvd):
        for i in range(5):
            h = side.hvd.allreduce_async(side.to(np.full(4, i, np.float32)))
            side.hvd.synchronize(h)
        p = side.fc.scheduler().stats()["pipeline"]
        got.append((p["enabled"], p["submitted"], p["executed"]))
    assert got[1] == got[0]


def test_chunked_wire_buffers_equal_unchunked(monkeypatch):
    """A wire buffer past ``HVD_PIPELINE_THRESHOLD`` issues as
    ``HVD_PIPELINE_CHUNKS`` chunk collectives, built once into a chunked
    plan; the result equals the one-buffer issue bit for bit."""
    x = [torch.arange(1000, dtype=torch.float32) - 500,
         torch.arange(300, dtype=torch.float32)]
    plain = thvd.grouped_allreduce(x, op=thvd.Sum)
    monkeypatch.setenv("HVD_PIPELINE_THRESHOLD", "1024")
    monkeypatch.setenv("HVD_PIPELINE_CHUNKS", "4")
    before = thvd.dispatch_cache_stats()["chunked_builds"]
    h = thvd.grouped_allreduce_async(x, op=thvd.Sum)
    chunked = h.synchronize()
    assert thvd.dispatch_cache_stats()["chunked_builds"] == before + 1
    for a, b in zip(plain, chunked):
        assert torch.equal(a, b)
