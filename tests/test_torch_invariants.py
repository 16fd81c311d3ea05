"""The port's invariant checker (``horovod_tpu_torch/utils/invariants.py``)
against the JAX package's: the same scripts of lock acquisitions, thread
checks and sections, made from a numpy seed, raise the same kinds of
violation at the same steps and leave the same counters; with the
checker on, the port's fusion cycle runs a stress of concurrent
submitters without a report; and the issue lock of
``ops/program_issue.py`` behaves as the JAX package's."""

import os
import threading

import numpy as np
import pytest
import torch

from horovod_tpu.utils import invariants as jinv
from horovod_tpu_torch.utils import invariants as tinv


@pytest.fixture
def checkers():
    prior = os.environ.get("HVD_DEBUG_INVARIANTS")
    os.environ["HVD_DEBUG_INVARIANTS"] = "1"
    for m in (jinv, tinv):
        m.refresh()
        m.reset()
    yield
    if prior is None:
        os.environ.pop("HVD_DEBUG_INVARIANTS", None)
    else:
        os.environ["HVD_DEBUG_INVARIANTS"] = prior
    for m in (jinv, tinv):
        m.refresh()
        m.reset()


def make_script(seed: int, n: int = 40) -> list:
    """Nested acquisitions of four named locks, in random orders."""
    rng = np.random.default_rng(seed)
    return [tuple(str(x) for x in rng.choice(
        ["a", "b", "c", "d"], size=int(rng.integers(1, 4)), replace=False))
        for _ in range(n)]


def run_script(inv, script) -> list:
    locks = {name: inv.make_lock(f"test.{name}") for name in "abcd"}
    outcome = []
    for chain in script:
        held = []
        try:
            for name in chain:
                locks[name].acquire()
                held.append(locks[name])
            outcome.append("ok")
        except inv.InvariantViolation as exc:
            outcome.append(str(exc).split("]")[0] + "]")
        finally:
            for lock in reversed(held):
                lock.release()
    return outcome


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lock_order_witness_equals_jax(checkers, seed):
    script = make_script(seed)
    want = run_script(jinv, script)
    got = run_script(tinv, script)
    assert got == want
    assert tinv.report()["counts"] == jinv.report()["counts"]
    assert "[lock-order]" in got or seed == 0


def test_affinity_holding_and_sections_equal_jax(checkers):
    """``assert_thread``, ``assert_holding`` and ``assert_outside``: the
    same violations on both, counted alike."""
    for inv in (jinv, tinv):
        lock = inv.make_lock("test.guard")
        other = threading.Thread(target=lambda: None)
        with pytest.raises(inv.InvariantViolation, match="thread-affinity"):
            inv.assert_thread(other, "owned state")
        inv.assert_thread(threading.current_thread(), "owned state")
        with pytest.raises(inv.InvariantViolation, match="lock-held"):
            inv.assert_holding(lock, "guarded state")
        with lock:
            inv.assert_holding(lock, "guarded state")
        with inv.section("flush"):
            assert inv.inside("flush")
            with pytest.raises(inv.InvariantViolation, match="reentrancy"):
                inv.assert_outside("flush", "enqueue")
        assert not inv.inside("flush")
    assert tinv.report()["counts"] == jinv.report()["counts"]


def test_disabled_checker_returns_plain_primitives():
    os.environ.pop("HVD_DEBUG_INVARIANTS", None)
    tinv.refresh()
    assert not tinv.enabled()
    assert type(tinv.make_lock("x")) is type(threading.Lock())
    assert isinstance(tinv.make_condition("x"), threading.Condition)
    tinv.assert_holding(tinv.make_lock("y"), "no-op when off")
    t = tinv.spawn_thread(lambda: None, name="hvd-test")
    tinv.join_thread(t, timeout=5)
    assert not t.is_alive()


def test_fusion_cycle_stress_reports_nothing(checkers, monkeypatch):
    """Four producer threads submit and synchronize async allreduces
    through the port's pipelined executor with the checker on: every
    result right, no invariant report."""
    import horovod_tpu_torch as thvd
    from horovod_tpu_torch.ops import fusion_cycle

    monkeypatch.setenv("HVD_CYCLE_TIME", "5")
    fusion_cycle.reset()  # primitives made with the checker on
    thvd.init(device="cpu")
    errors = []

    def producer(k):
        try:
            for i in range(25):
                h = thvd.allreduce_async(torch.full((4,), float(k * 100 + i)),
                                         op=thvd.Sum)
                if i % 3 == 0:
                    h.flush()
                got = h.synchronize()
                assert got.tolist() == [float(k * 100 + i)] * 4
        except BaseException as exc:  # reported below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=producer, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        rep = tinv.report()
        assert rep["enabled"] and sum(rep["counts"].values()) == 0, rep
    finally:
        thvd.shutdown()
        fusion_cycle.reset()


def test_program_issue_lock_equals_jax():
    """``ops/program_issue.py``: outside a serialized issue the lock is not
    held, inside a wrapped call it is, nested calls re-enter, and the
    wrapper returns the call's result, on both packages."""
    from horovod_tpu.ops import program_issue as jpi
    from horovod_tpu_torch.ops import program_issue as tpi

    for pi in (jpi, tpi):
        seen = []

        def inner():
            seen.append(pi.issue_lock_held())
            return 7

        outer = pi.issue_serialized(lambda: (pi.issue_serialized(inner)(),
                                             pi.issue_lock_held()))
        assert not pi.issue_lock_held()
        assert outer() == (7, True) and seen == [True]
        assert not pi.issue_lock_held()
