"""The port's autoscale policy (``horovod_tpu_torch/elastic/policy.py``)
against the JAX package's.

* **Decisions.** Every scenario of the JAX package's ``TestPolicyRules`` and
  ``TestPolicyRobustness`` (``tests/test_autoscale.py``) is one case: both
  packages' :class:`AutoscalePolicy` get the same stub driver, an in-memory
  KV store, the same sensor blobs and one frozen clock, their ``tick()`` is
  called directly, and each window's decision (``as_dict()``, field by
  field), the host set, the graced hosts and ``policy_stats()`` must be
  equal. One case differs by design and says so: a scale-up after a
  scale-down re-admits the host the policy removed (a worker is a process
  here, started on a named machine), where the JAX package mints
  ``auto0``.
* **Observer.** The same commit times give the same sensor blobs.
* **A closed loop of processes.** ``start_elastic`` of two gloo workers
  (this file as the worker) on ``-H localhost:1,127.0.0.1:1`` under
  ``HVD_AUTOSCALE``: an idle load makes the policy remove the host of rank
  1 (2 -> 1), a load past the SLO makes it re-admit that host (1 -> 2).
  The workers' load follows the world they see, never the clock, and each
  step time keeps a 3x margin to its threshold; the test asserts which
  decisions came and in what order, never when.

The JAX package is imported inside the tests only: the worker side of
this file imports none of it.
"""

import json
import os
import sys
import threading
import time
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# the two sides
# ---------------------------------------------------------------------------

class _KV(dict):
    def put(self, k, v):
        self[k] = v

    def get(self, k):
        return dict.get(self, k)

    def keys(self, scope=""):
        prefix = scope.rstrip("/") + "/" if scope else ""
        return sorted(k for k in dict.keys(self) if k.startswith(prefix))


def _slot(rank, host, size=3, local_rank=0):
    from horovod_tpu_torch.runner.hosts import SlotInfo
    return SlotInfo(hostname=host, rank=rank, size=size,
                    local_rank=local_rank, local_size=1, cross_rank=rank,
                    cross_size=size)


class _StubRendezvous:
    def __init__(self):
        self.round_id = 1


class _StubDriver:
    def __init__(self, hosts_by_rank):
        self._rendezvous = _StubRendezvous()
        self._round_lock = threading.RLock()
        self._rank_assignments = {
            r: _slot(r, h, len(hosts_by_rank))
            for r, h in hosts_by_rank.items()}
        self.graced = []

    def world_size(self):
        return len(self._rank_assignments)

    def set_stale_grace(self, host, s):
        self.graced.append((host, s))

    def has_rank_assignment(self, host, slot):
        return any(s.hostname == host for s in
                   self._rank_assignments.values())


def _side(which: str, monkeypatch, clock):
    """One package's policy pieces, with its policy module's clock frozen
    at ``clock[0]`` (only that module's: the package's own threads keep
    the real one)."""
    if which == "jax":
        from horovod_tpu import metrics
        from horovod_tpu.elastic import policy
        from horovod_tpu.elastic.discovery import FixedHosts
        from horovod_tpu.utils import faults, invariants
    else:
        from horovod_tpu_torch import metrics
        from horovod_tpu_torch.elastic import policy
        from horovod_tpu_torch.elastic.discovery import FixedHosts
        from horovod_tpu_torch.utils import faults, invariants
    frozen = types.SimpleNamespace(
        monotonic=lambda: clock[0], make_lock=invariants.make_lock,
        make_event=invariants.make_event,
        spawn_thread=invariants.spawn_thread,
        join_thread=invariants.join_thread)
    monkeypatch.setattr(policy, "_inv", frozen)

    def mk(driver=None, *, min_np=2, max_np=4, slo_ms="100", breach=2,
           idle=2, evict=2, cooldown="0"):
        for k, v in {"HVD_AUTOSCALE": "1", "HVD_AUTOSCALE_SLO_MS": slo_ms,
                     "HVD_AUTOSCALE_BREACH_WINDOWS": str(breach),
                     "HVD_AUTOSCALE_IDLE_WINDOWS": str(idle),
                     "HVD_AUTOSCALE_EVICT_WINDOWS": str(evict),
                     "HVD_AUTOSCALE_COOLDOWN": cooldown}.items():
            monkeypatch.setenv(k, v)
        driver = driver or _StubDriver({0: "h0", 1: "h1", 2: "h2"})
        hosts = FixedHosts(
            {s.hostname: 1 for s in driver._rank_assignments.values()})
        kv = _KV()
        pol = policy.AutoscalePolicy(driver, hosts, kv, min_np=min_np,
                                     max_np=max_np)
        return pol, driver, hosts, kv

    def blob(kv, rank, *, round_id=1, seq, steps=10, violations=0,
             step_s_mean=0.02, pending=0.0, straggler=None,
             restore_s_sum=None, restore_count=None):
        body = {"rank": rank, "round": round_id, "seq": seq, "steps": steps,
                "violations": violations, "step_s_mean": step_s_mean,
                "pending_bytes": pending, "qos_wait_s_mean": 0.0,
                "straggler": straggler or {}}
        if restore_count is not None:
            body.update(restore_s_sum=restore_s_sum,
                        restore_count=restore_count)
        kv.put(policy.sensor_key(rank), json.dumps(body).encode())

    return types.SimpleNamespace(which=which, mk=mk, blob=blob,
                                 policy=policy, faults=faults,
                                 metrics=metrics, clock=clock,
                                 monkeypatch=monkeypatch)


def _window(trace, pol, driver, hosts, d):
    trace.append({
        "decision": None if d is None else d.as_dict(),
        "hosts": hosts.find_available_hosts_and_slots(),
        "graced": list(driver.graced),
        "stats": pol.policy_stats()})
    return d


# ---------------------------------------------------------------------------
# the scenarios of tests/test_autoscale.py, each on either package
# ---------------------------------------------------------------------------

def sc_scale_up_after_consecutive_breaches(P):
    pol, driver, hosts, kv = P.mk()
    trace = []
    for r in range(3):
        P.blob(kv, r, seq=1, violations=8)
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    for r in range(3):
        P.blob(kv, r, seq=2, violations=8)
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("add", "slo-breach")
    assert "auto0" in hosts.find_available_hosts_and_slots()
    assert pol.policy_stats()["breach_streak"] == 0
    return trace


def sc_breach_needs_majority_violation_share(P):
    pol, driver, hosts, kv = P.mk(breach=1)
    trace = []
    for r in range(3):
        P.blob(kv, r, seq=1, steps=10, violations=2 if r == 0 else 0)
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    assert pol.policy_stats()["breach_streak"] == 0
    return trace


def sc_scale_up_respects_ceiling(P):
    pol, driver, hosts, kv = P.mk(_StubDriver({r: f"h{r}" for r in range(4)}),
                                  max_np=4, breach=1)
    trace = []
    for r in range(4):
        P.blob(kv, r, seq=1, violations=9)
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    assert "auto0" not in hosts.find_available_hosts_and_slots()
    return trace


def sc_idle_scale_down_graceful_highest_rank(P):
    pol, driver, hosts, kv = P.mk(idle=2)
    trace = []
    for seq in (1, 2):
        for r in range(3):
            P.blob(kv, r, seq=seq, violations=0, step_s_mean=0.01)
        d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("remove", "idle")
    assert driver.graced[0][0] == "h2"
    assert "h2" not in hosts.find_available_hosts_and_slots()
    return trace


def sc_idle_needs_every_rank_reporting(P):
    pol, driver, hosts, kv = P.mk(idle=1)
    trace = []
    for r in range(2):
        P.blob(kv, r, seq=1, violations=0, step_s_mean=0.01)
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    assert pol.policy_stats()["idle_streak"] == 0
    return trace


def sc_scale_down_respects_floor(P):
    pol, driver, hosts, kv = P.mk(_StubDriver({0: "h0", 1: "h1"}),
                                  min_np=2, idle=1)
    trace = []
    for r in range(2):
        P.blob(kv, r, seq=1, violations=0, step_s_mean=0.01)
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    assert "h1" in hosts.find_available_hosts_and_slots()
    return trace


def sc_evict_names_blamed_rank_and_replaces(P):
    pol, driver, hosts, kv = P.mk(evict=2)
    labels = {"action": "evict", "reason": "straggler", "rank": "2"}
    before = P.metrics.ELASTIC_POLICY_DECISIONS.value(labels=labels)
    trace = []
    for seq in (1, 2):
        for r in (0, 1):
            P.blob(kv, r, seq=seq, straggler={"2": 3})
        d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason, d.rank) == ("evict", "straggler", 2)
    live = hosts.find_available_hosts_and_slots()
    assert "h2" not in live and "auto0" in live
    assert P.metrics.ELASTIC_POLICY_DECISIONS.value(
        labels=labels) == before + 1
    return trace


def sc_evict_blame_streak_must_be_same_rank(P):
    pol, driver, hosts, kv = P.mk(evict=2)
    trace = []
    P.blob(kv, 0, seq=1, straggler={"2": 3})
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    P.blob(kv, 0, seq=2, straggler={"1": 3})
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    assert pol.policy_stats()["blame"] == (1, 1)
    return trace


def sc_refuses_to_evict_rank0(P):
    pol, driver, hosts, kv = P.mk(evict=1)
    trace = []
    P.blob(kv, 1, seq=1, straggler={"0": 5})
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("hold", "protected")
    return trace


def sc_protected_blame_never_starves_breach_rule(P):
    pol, driver, hosts, kv = P.mk(evict=2, breach=3)
    trace = []
    for seq in (1, 2):
        P.blob(kv, 0, seq=seq, violations=8, straggler={"0": 5})
        d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("hold", "protected")
    assert pol.policy_stats()["blame"] == (None, 0)
    P.blob(kv, 0, seq=3, violations=8, straggler={"0": 5})
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("add", "slo-breach")
    return trace


def sc_remove_never_breaks_floor_with_multislot_host(P):
    pol, driver, hosts, kv = P.mk(
        _StubDriver({0: "h0", 1: "h0", 2: "h1", 3: "h1"}), min_np=3, idle=1)
    trace = []
    for r in range(4):
        P.blob(kv, r, seq=1, violations=0, step_s_mean=0.01)
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("hold", "protected")
    assert "h1" in hosts.find_available_hosts_and_slots()
    return trace


def sc_evict_replacement_matches_victim_slot_count(P):
    pol, driver, hosts, kv = P.mk(_StubDriver({0: "h0", 1: "h1", 2: "h1"}),
                                  evict=1)
    trace = []
    P.blob(kv, 0, seq=1, straggler={"2": 5})
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason, d.rank) == ("evict", "straggler", 2)
    live = hosts.find_available_hosts_and_slots()
    assert "h1" not in live and live.get("auto0") == 2
    return trace


def sc_apply_blocked_by_inflight_reform_holds(P):
    pol, driver, hosts, kv = P.mk(evict=1)
    trace = []
    P.blob(kv, 0, seq=1, straggler={"2": 5})
    acquired, release = threading.Event(), threading.Event()

    def holder():
        with driver._round_lock:
            acquired.set()
            release.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    assert acquired.wait(5)
    try:
        d = _window(trace, pol, driver, hosts, pol.tick())
    finally:
        release.set()
        t.join()
    assert (d.action, d.reason) == ("hold", "stale-round")
    assert "h2" in hosts.find_available_hosts_and_slots()
    return trace


def sc_stale_round_decision_is_noop(P):
    pol, driver, hosts, kv = P.mk(evict=1)
    trace = []
    P.blob(kv, 0, seq=1, straggler={"2": 5})
    orig = pol._stale

    def reform_then_check(round_id):
        driver._rendezvous.round_id = 2  # a re-form lands mid-apply
        return orig(round_id)

    P.monkeypatch.setattr(pol, "_stale", reform_then_check)
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("hold", "stale-round")
    assert "h2" in hosts.find_available_hosts_and_slots()
    return trace


def sc_blaming_a_rank_that_left_is_noop(P):
    pol, driver, hosts, kv = P.mk(evict=1)
    trace = []
    P.blob(kv, 0, seq=1, straggler={"2": 5})
    del driver._rank_assignments[2]
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason, d.rank) == ("hold", "stale-round", 2)
    assert pol.policy_stats()["blame"] == (None, 0)
    return trace


def sc_stale_sensor_round_ignored(P):
    pol, driver, hosts, kv = P.mk(breach=1)
    trace = []
    for r in range(3):
        P.blob(kv, r, round_id=0, seq=1, violations=9)
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    assert pol.policy_stats()["breach_streak"] == 0
    return trace


def sc_eval_error_degrades_to_hold(P):
    pol, driver, hosts, kv = P.mk(breach=1)
    trace = []
    P.monkeypatch.setenv("HVD_FAULT_SPEC", "policy.eval:error:times=1")
    P.faults.refresh()
    try:
        d = _window(trace, pol, driver, hosts, pol.tick())
        assert (d.action, d.reason) == ("hold", "error")
        assert "injected fault" in d.detail
        for r in range(3):
            P.blob(kv, r, seq=1, violations=9)
        d2 = _window(trace, pol, driver, hosts, pol.tick())
        assert d2.action == "add"
    finally:
        P.monkeypatch.delenv("HVD_FAULT_SPEC")
        P.faults.refresh()
    return trace


def sc_sensor_garbage_degrades_to_hold(P):
    pol, driver, hosts, kv = P.mk(breach=1)
    trace = []
    kv.put(P.policy.sensor_key(0), b"\xff not json")
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    return trace


def sc_cooldown_blocks_consecutive_actions(P):
    pol, driver, hosts, kv = P.mk(breach=1, cooldown="60")
    trace = []
    for r in range(3):
        P.blob(kv, r, seq=1, violations=9)
    assert _window(trace, pol, driver, hosts, pol.tick()).action == "add"
    for r in range(3):
        P.blob(kv, r, seq=2, violations=9)
    assert _window(trace, pol, driver, hosts, pol.tick()) is None
    assert pol.policy_stats()["cooldown_remaining_s"] > 0
    P.clock[0] += 61.0  # past the cooldown: the streak acts again
    for r in range(3):
        P.blob(kv, r, seq=3, violations=9)
    assert _window(trace, pol, driver, hosts, pol.tick()).action == "add"
    return trace


def sc_adversarial_flapping_produces_no_action(P):
    pol, driver, hosts, kv = P.mk(breach=2, idle=2)
    trace = []
    for seq in range(1, 13):
        breach = seq % 2 == 0
        for r in range(3):
            P.blob(kv, r, seq=seq, violations=9 if breach else 0,
                   step_s_mean=0.2 if breach else 0.01)
        assert _window(trace, pol, driver, hosts, pol.tick()) is None
    assert pol.policy_stats()["decisions"] == []
    return trace


def sc_restore_cost_brakes_the_remove(P):
    """Not a case of the JAX tests: the measured recovery time (5 s a
    re-form) exceeds the idle windows' savings (2 x 2 s), so the remove is
    held; a cheap one (0.5 s) lets it through."""
    pol, driver, hosts, kv = P.mk(idle=2)
    pol.interval_s = 2.0
    trace = []
    for seq in (1, 2):
        for r in range(3):
            P.blob(kv, r, seq=seq, step_s_mean=0.01, restore_s_sum=5.0,
                   restore_count=1 if seq == 1 else 0)
        d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("hold", "restore-cost")
    pol2, driver2, hosts2, kv2 = P.mk(idle=2)
    pol2.interval_s = 2.0
    for seq in (1, 2):
        for r in range(3):
            P.blob(kv2, r, seq=seq, step_s_mean=0.01, restore_s_sum=0.5,
                   restore_count=1 if seq == 1 else 0)
        d = _window(trace, pol2, driver2, hosts2, pol2.tick())
    assert (d.action, d.reason) == ("remove", "idle")
    return trace


def sc_remove_then_add_readmits(P):
    """The difference by design: after an idle scale-down of ``h2`` the
    next scale-up brings ``h2`` back in the port (a machine a worker can
    be started on), where the JAX package mints ``auto0``."""
    pol, driver, hosts, kv = P.mk(idle=1, breach=1, min_np=2)
    trace = []
    for r in range(3):
        P.blob(kv, r, seq=1, step_s_mean=0.01)
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("remove", "idle")
    del driver._rank_assignments[2]  # the world re-formed at 2
    driver._rendezvous.round_id = 2
    for r in range(2):
        P.blob(kv, r, round_id=2, seq=1, violations=9)
    d = _window(trace, pol, driver, hosts, pol.tick())
    assert (d.action, d.reason) == ("add", "slo-breach")
    return trace


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}
# the cases whose decisions differ between the packages by design
READMISSION_CASES = {"remove_then_add_readmits"}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_decisions_equal_jax(name, monkeypatch):
    traces = {}
    for which in ("jax", "port"):
        clock = [1000.0]
        traces[which] = SCENARIOS[name](_side(which, monkeypatch, clock))
    jax_trace, port_trace = traces["jax"], traces["port"]
    assert len(jax_trace) == len(port_trace)
    if name not in READMISSION_CASES:
        assert port_trace == jax_trace
        return
    # the first window (the remove) agrees; the add brings back h2 in the
    # port and mints auto0 in the JAX package
    assert port_trace[0] == jax_trace[0]
    jd, pd = jax_trace[1]["decision"], port_trace[1]["decision"]
    assert {k: v for k, v in jd.items() if k != "detail"} == \
        {k: v for k, v in pd.items() if k != "detail"}
    assert jd["detail"].startswith("+auto0 ")
    assert pd["detail"].startswith("+h2 ")
    assert port_trace[1]["hosts"] == {"h0": 1, "h1": 1, "h2": 1}
    assert jax_trace[1]["hosts"] == {"h0": 1, "h1": 1, "auto0": 1}


def test_evict_replacement_readmits_a_host_that_covers_the_victim():
    """The port's replacement order: a host taken out earlier whose own
    slots cover the victim's (never the victim), at the victim's count,
    else a minted name; a scale-up brings a host back at its own count."""
    from horovod_tpu_torch.elastic.discovery import FixedHosts
    from horovod_tpu_torch.elastic.policy import AutoscalePolicy
    driver = _StubDriver({0: "h0", 1: "h1", 2: "h2"})
    hosts = FixedHosts({"h0": 1, "h1": 1, "h2": 1, "old": 3, "big": 2})
    hosts.remove_host("old")
    hosts.remove_host("big")
    pol = AutoscalePolicy(driver, hosts, _KV(), min_np=1, max_np=4)
    assert pol._new_host(2, exclude=("h2",)) == {"old": 2}
    assert pol._new_host(None) == {"big": 2}
    assert pol._new_host(None) == {"auto0": 1}
    hosts.remove_host("h2")
    assert pol._new_host(1, exclude=("h2",)) == {"auto1": 1}
    assert hosts.readmit(5) == {"h2": 1}


def test_evict_replacement_never_readmits_a_host_of_fewer_slots():
    """A host taken out with fewer slots than the victim has cards for
    fewer workers: the replacement is a minted name, and the small host
    stays removed for a later scale-up."""
    from horovod_tpu_torch.elastic.discovery import FixedHosts
    from horovod_tpu_torch.elastic.policy import AutoscalePolicy
    driver = _StubDriver({0: "h0", 1: "h1", 2: "h1"})
    hosts = FixedHosts({"h0": 1, "h1": 2, "old": 1})
    hosts.remove_host("old")
    pol = AutoscalePolicy(driver, hosts, _KV(), min_np=1, max_np=4)
    assert pol._new_host(2, exclude=("h1",)) == {"auto0": 2}
    assert pol._new_host(None) == {"old": 1}


class _Proc:
    def __init__(self):
        self.code = None
        self.terminated = False

    def poll(self):
        return self.code

    def terminate(self):
        self.terminated = True
        self.code = -15


def test_card_pool_waits_for_a_freed_card(monkeypatch):
    """A replacement spawned while every card of its machine is held (its
    victims drain in their grace window) takes the first card that frees,
    never a card past the machine's; with none freed it raises."""
    import socket

    from horovod_tpu_torch.runner import launch as launch_mod
    monkeypatch.setattr(launch_mod, "_local_card_count", lambda: 2)
    pool = launch_mod.CardPool()
    held = [pool.spawn("localhost", lambda card: _Proc()) for _ in range(2)]
    timer = threading.Timer(0.3, lambda: setattr(held[1], "code", 66))
    timer.start()
    got = []
    t0 = time.monotonic()
    # the machine's own name: one pool with localhost
    pool.spawn(socket.gethostname(), lambda card: got.append(card) or _Proc(),
               wait_s=5.0)
    assert got == [1] and time.monotonic() - t0 >= 0.2
    with pytest.raises(RuntimeError, match="no free card"):
        pool.spawn("127.0.0.1", lambda card: _Proc(), wait_s=0.2)
    with pytest.raises(RuntimeError, match="no free card"):
        pool.spawn("127.0.0.1", lambda card: _Proc())  # a static launch


@pytest.mark.parametrize("elastic,policy,want", [
    (None, 0.0, 0.0), ("45", 0.0, 45.0), ("45", 120.0, 120.0),
    (None, 30.0, 30.0)])
def test_card_wait_follows_the_departure_grace(monkeypatch, elastic, policy,
                                              want):
    """The elastic launcher's spawn waits as long as the longest grace a
    departing worker gets (``HVD_ELASTIC_GRACE`` or the policy's), then its
    termination."""
    from horovod_tpu_torch.runner import launch as launch_mod
    from horovod_tpu_torch.runner import safe_exec
    monkeypatch.delenv("HVD_ELASTIC_GRACE", raising=False)
    monkeypatch.delenv("HOROVOD_ELASTIC_GRACE", raising=False)
    if elastic is not None:
        monkeypatch.setenv("HVD_ELASTIC_GRACE", elastic)
    assert launch_mod.departure_wait_s(policy) == \
        want + safe_exec.GRACEFUL_TERMINATION_TIME_S


def test_stale_grace_covers_every_slot_of_the_host(monkeypatch):
    """A policy's graceful departure of a host of two slots grants both of
    its workers the grace (it was one before: the second was terminated
    at once, mid-collective)."""
    from horovod_tpu_torch.elastic import driver as drv
    d = drv.ElasticDriver.__new__(drv.ElasticDriver)
    d._stale_grace = {}
    d._proc_lock = threading.Lock()
    d._shutdown = threading.Event()
    d._result_threads = []
    procs = {("h1", 0): _Proc(), ("h1", 1): _Proc(), ("h2", 0): _Proc()}
    d._active_procs = dict(procs)
    monkeypatch.delenv("HVD_ELASTIC_GRACE", raising=False)
    d.set_stale_grace("h1", 30.0)
    d._stop_stale_workers([("h1", 0), ("h1", 1), ("h2", 0)])
    assert not procs[("h1", 0)].terminated
    assert not procs[("h1", 1)].terminated
    assert procs[("h2", 0)].terminated  # no grace given: at once
    assert d._stale_grace == {}  # used up
    d._shutdown.set()
    for t in d._result_threads:
        t.join(5)


# ---------------------------------------------------------------------------
# the observer
# ---------------------------------------------------------------------------

OBSERVER_CASES = {
    # (SLO ms, policy interval s, commit times s, blames a commit)
    "breach": ("100", "1.0", [0.0, 0.05, 0.3, 0.31, 0.9, 1.6, 1.62, 3.0],
               None),
    "no_slo": ("0", "0.5", [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.9], None),
    "blames": ("50", "0.2", [0.0, 0.2, 0.4, 0.45, 0.7], [{}, {3: 2}, {3: 2},
                                                          {3: 5, 1: 1},
                                                          {3: 5, 1: 1}]),
}


@pytest.mark.parametrize("case", sorted(OBSERVER_CASES))
def test_observer_blobs_equal_jax(case, monkeypatch):
    slo, interval, times, blames = OBSERVER_CASES[case]
    monkeypatch.setenv("HVD_AUTOSCALE", "1")
    monkeypatch.setenv("HVD_AUTOSCALE_SLO_MS", slo)
    monkeypatch.setenv("HVD_AUTOSCALE_INTERVAL", interval)
    monkeypatch.setenv("HVD_RANK", "1")
    monkeypatch.setenv("HVD_ELASTIC_ROUND", "3")
    out = {}
    for which in ("jax", "port"):
        clock = [0.0]
        P = _side(which, monkeypatch, clock)
        calls = [0]
        monkeypatch.setattr(
            P.policy._health, "straggler_blames",
            lambda: dict(blames[min(calls[0], len(blames) - 1)])
            if blames else {})
        monkeypatch.setattr(P.policy, "_qos_wait_totals",
                            lambda: (0.25 * calls[0], calls[0]))
        monkeypatch.setattr(P.policy, "_recovery_totals",
                            lambda: (0.5 * (calls[0] // 2), calls[0] // 2))
        monkeypatch.setattr(P.metrics.FUSION_PENDING_BYTES, "value",
                            lambda labels=None, default=0.0: 0.0)
        obs = P.policy.CommitObserver()
        kv = _KV()
        puts = []
        kv.put = lambda k, v, puts=puts: puts.append((k, json.loads(v)))
        obs._client = kv
        v0 = P.metrics.ELASTIC_SLO_VIOLATIONS.value()
        for i, t in enumerate(times):
            clock[0] = t
            calls[0] = i
            obs.note()
        out[which] = (puts, P.metrics.ELASTIC_SLO_VIOLATIONS.value() - v0)
    assert out["port"] == out["jax"]
    puts, violations = out["port"]
    assert puts and all(k == "autoscale/sensor/1" for k, _ in puts)
    assert [b["seq"] for _, b in puts] == list(range(1, len(puts) + 1))
    assert all(b["round"] == 3 for _, b in puts)
    if case == "breach":
        assert violations >= 1
    if case == "blames":
        assert any(b["straggler"] for _, b in puts)


def test_note_commit_is_one_cached_check_when_off(monkeypatch):
    from horovod_tpu_torch.elastic import policy, state
    monkeypatch.delenv("HVD_AUTOSCALE", raising=False)
    policy.reset_observer()
    try:
        policy.note_commit()
        assert policy._process_observer is False
        policy.note_commit()
        assert state._policy is policy
    finally:
        policy.reset_observer()


def test_straggler_blames_equal_jax():
    from horovod_tpu import health as jhealth
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu_torch import health, metrics
    for m in (jmetrics, metrics):
        m.STRAGGLER_ROUNDS.inc(labels={"rank": 5})
        m.STRAGGLER_ROUNDS.inc(labels={"rank": 5})
    j, p = jhealth.straggler_blames(), health.straggler_blames()
    assert p.get(5, 0) >= 2 and j.get(5, 0) >= 2
    assert set(p) <= set(range(64)) and all(
        isinstance(v, int) for v in p.values())


def test_knobs_and_names_equal_jax():
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu.utils import envs as jenvs
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.utils import envs
    for name in dir(jenvs):
        if name.startswith(("AUTOSCALE", "DEFAULT_AUTOSCALE")) \
                or name == "SPARK_START_TIMEOUT":
            assert getattr(envs, name) == getattr(jenvs, name), name
    for name in ("ELASTIC_STEP_SECONDS", "ELASTIC_SLO_VIOLATIONS",
                 "ELASTIC_POLICY_DECISIONS"):
        assert getattr(metrics, name).name == getattr(jmetrics, name).name
        assert getattr(metrics, name).labelnames == \
            getattr(jmetrics, name).labelnames


def test_maybe_start_needs_the_knob_and_a_mutable_discovery():
    from horovod_tpu_torch.elastic import policy
    from horovod_tpu_torch.elastic.discovery import (FixedHosts,
                                                     HostDiscoveryScript)
    driver = _StubDriver({0: "h0"})
    assert policy.maybe_start(driver, FixedHosts({"h0": 1}), _KV(),
                              min_np=1, env={}) is None
    assert policy.maybe_start(
        driver, HostDiscoveryScript("/bin/true"), _KV(), min_np=1,
        env={"HVD_AUTOSCALE": "1"}) is None
    pol = policy.maybe_start(
        driver, FixedHosts({"h0": 1}), _KV(), min_np=1, max_np=3,
        env={"HVD_AUTOSCALE": "1", "HVD_AUTOSCALE_INTERVAL": "0.05"})
    try:
        assert isinstance(pol, policy.AutoscalePolicy)
        assert pol.policy_stats()["bounds"] == (1, 3)
        assert pol._thread is not None and pol._thread.is_alive()
    finally:
        pol.stop()
    assert pol._thread is None


# ---------------------------------------------------------------------------
# a closed loop of gloo processes through start_elastic
# ---------------------------------------------------------------------------

# SLO 300 ms, idle under 0.5 x SLO = 150 ms: an idle step sleeps 20 ms
# (7.5x under), a busy one 1000 ms (3.3x over).
LOOP_SLO_MS, IDLE_S, BUSY_S = 300, 0.02, 1.0
LOOP_TAIL_STEPS, LOOP_MAX_STEPS = 6, 3000
LOOP_ENV = {"HVD_AUTOSCALE": "1", "HVD_AUTOSCALE_SLO_MS": str(LOOP_SLO_MS),
            "HVD_AUTOSCALE_INTERVAL": "0.5",
            "HVD_AUTOSCALE_IDLE_WINDOWS": "3",
            "HVD_AUTOSCALE_BREACH_WINDOWS": "2",
            "HVD_AUTOSCALE_IDLE_FACTOR": "0.5",
            "HVD_AUTOSCALE_COOLDOWN": "2", "HVD_AUTOSCALE_GRACE": "60",
            "HVD_HEALTH_INTERVAL": "0.5", "HVD_HEALTH_TIMEOUT": "30",
            "HVD_CYCLE_TIME": "200"}


def _loop_worker(out_dir: str) -> None:
    """The closed loop's worker: a linear regression under TorchState.
    The load follows the world: idle at 2 until the world shrinks, busy
    at 1 until it grows, then LOOP_TAIL_STEPS idle steps and done."""
    import hashlib

    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics

    hvd.init(device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    y = x @ torch.arange(1.0, 9.0)[:, None]
    model = torch.nn.Linear(8, 1, bias=False)
    with torch.no_grad():
        model.weight.zero_()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0,
                                   phase="idle", tail_from=-1, log=[])

    @hvd.elastic.run
    def train(state):
        while state.step < LOOP_MAX_STEPS:
            size = hvd.size()
            if state.phase == "idle" and size == 1:
                state.phase = "busy"
            elif state.phase == "busy" and size == 2:
                state.phase, state.tail_from = "tail", state.step
            if state.phase == "tail" \
                    and state.step >= state.tail_from + LOOP_TAIL_STEPS:
                break
            opt.zero_grad()
            ((model(x) - y) ** 2).mean().backward()
            opt.step()
            time.sleep(BUSY_S if state.phase == "busy" else IDLE_S)
            state.log = state.log + [[state.step, size, state.phase]]
            state.step += 1
            state.commit()
        return state.log

    log = train(state)
    digest = hashlib.sha256(model.weight.detach().numpy().tobytes())
    with open(os.path.join(out_dir, f"result.{os.getpid()}.json"),
              "w") as f:
        json.dump({"rank": hvd.rank(), "size": hvd.size(), "log": log,
                   "digest": digest.hexdigest(),
                   "lost": metrics.ELASTIC_STEPS_LOST.value()}, f)
    hvd.shutdown()


def test_closed_loop_removes_idle_host_then_readmits_it(tmp_path,
                                                        monkeypatch):
    from horovod_tpu_torch.elastic import launch as elastic_launch
    from horovod_tpu_torch.runner import launch as launch_mod
    for k in [k for k in os.environ if k.startswith(("HVD_", "HOROVOD_"))]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    args = launch_mod.parse_args(
        ["-np", "2", "--min-np", "1", "--max-np", "2",
         "-H", "localhost:1,127.0.0.1:1",
         *[a for k, v in LOOP_ENV.items() for a in ("--env", f"{k}={v}")],
         "--", sys.executable, str(Path(__file__).resolve()), "loop",
         str(tmp_path)])
    job = elastic_launch.start_elastic(args, args.command[1:])
    assert job.policy is not None
    deadline = time.monotonic() + 240
    waiter = threading.Thread(target=lambda: setattr(job, "rc", job.wait()),
                              daemon=True)
    waiter.start()
    waiter.join(max(0.0, deadline - time.monotonic()))
    if waiter.is_alive():
        job.driver.stop(error_message="the closed loop did not finish")
        waiter.join(60)
        pytest.fail(f"the closed loop did not finish: "
                    f"{job.policy.policy_stats()}")
    assert job.rc == 0
    decisions = [(d["action"], d["reason"])
                 for d in job.policy.policy_stats()["decisions"]
                 if d["action"] != "hold"]
    assert decisions[:2] == [("remove", "idle"), ("add", "slo-breach")], \
        decisions
    assert len(decisions) <= 3, decisions
    details = [d["detail"] for d in job.policy.policy_stats()["decisions"]
               if d["action"] in ("remove", "add")]
    # the host of the highest rank left, and came back, not a minted name
    gone = details[0].split()[0][1:]
    assert gone in ("localhost", "127.0.0.1"), details
    assert details[1].startswith(f"+{gone} "), details
    results = [json.loads(p.read_text())
               for p in sorted(tmp_path.glob("result.*.json"))]
    assert sorted(r["rank"] for r in results) == [0, 1], results
    assert all(r["size"] == 2 for r in results)
    assert len({r["digest"] for r in results}) == 1  # ranks bitwise equal
    log = next(r for r in results if r["rank"] == 0)["log"]
    steps = [row[0] for row in log]
    assert steps == list(range(len(steps)))  # no committed step replays
    worlds = [row[1] for row in log]
    first_one = worlds.index(1)
    assert set(worlds[:first_one]) == {2}
    assert 2 in worlds[first_one:] and worlds[-1] == 2
    assert all(r["lost"] == 0 for r in results)


if __name__ == "__main__":
    if sys.argv[1] == "loop":
        _loop_worker(sys.argv[2])
