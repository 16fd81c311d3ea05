"""The port's elastic driver side (``horovod_tpu_torch/elastic``: driver,
registration, discovery, rendezvous, scripted churn) against the JAX
package's, in one process.

Both packages' ``ElasticDriver`` run the same scripted scenario with fake
worker processes (the cases of ``tests/test_elastic.py``): the same
sequence of rounds and slot tables, the same spawns, blacklist decisions
and results. Host managers, discovery scripts, the registry, the churn
handler, the peer-failure records and the fault grammar's membership
actions are held to the JAX package's on the same inputs, and the
worker's rendezvous to its round protocol on a live KV store."""

import os
import pickle
import threading
import time

import pytest

import horovod_tpu.elastic as jel
from horovod_tpu import health as jhealth
from horovod_tpu.elastic import discovery as jdisc
from horovod_tpu.elastic import driver as jdrv
from horovod_tpu.elastic import rendezvous as jrdv
from horovod_tpu.runner import http_kv as jkv
from horovod_tpu.utils import faults as jfaults
import horovod_tpu_torch.elastic as tel
from horovod_tpu_torch import health as thealth
from horovod_tpu_torch.elastic import discovery as tdisc
from horovod_tpu_torch.elastic import driver as tdrv
from horovod_tpu_torch.elastic import notification as tnote
from horovod_tpu_torch.elastic import rendezvous as trdv
from horovod_tpu_torch.runner import http_kv as tkv
from horovod_tpu_torch.utils import faults as tfaults

PACKAGES = {"jax": (jel, jdrv, jdisc, jkv), "torch": (tel, tdrv, tdisc, tkv)}
WAIT_S = 10.0


@pytest.fixture(autouse=True)
def _fast_discovery(monkeypatch):
    """Both drivers poll their discovery every 50 ms instead of 1 s."""
    for drv in (jdrv, tdrv):
        monkeypatch.setattr(drv, "DISCOVER_HOSTS_FREQUENCY_S", 0.05)


class FakeProc:
    """A worker process whose exit the scenario scripts."""

    def __init__(self):
        self._exit = threading.Event()
        self._code = None

    def exit(self, code):
        self._code = code
        self._exit.set()

    def wait(self, timeout=None):
        self._exit.wait(timeout)
        return self._code

    def poll(self):
        return self._code if self._exit.is_set() else None

    def terminate(self):
        if not self._exit.is_set():
            self.exit(143)


class Harness:
    """One package's driver over fixed hosts, with fake workers."""

    def __init__(self, pkg, host_slots, min_np, max_np=None, **kw):
        el, drv, disc, kv = PACKAGES[pkg]
        self.drv = drv
        self.kv = kv.KVServer()
        self.kv.start()
        self.discovery = disc.FixedHosts(host_slots)
        self.rendezvous = drv.ElasticRendezvous(self.kv)
        self.driver = drv.ElasticDriver(self.rendezvous, self.discovery,
                                        min_np, max_np, timeout=WAIT_S, **kw)
        self.procs: dict = {}  # (host, slot) -> [FakeProc per spawn]
        self.lock = threading.Lock()

    def create_worker(self, slot_info, spec_round):
        proc = FakeProc()
        with self.lock:
            self.procs.setdefault(
                (slot_info.hostname, slot_info.local_rank), []).append(proc)
        return proc

    def until(self, cond, what):
        deadline = time.monotonic() + WAIT_S
        while not cond():
            assert time.monotonic() < deadline, f"waited for {what}"
            time.sleep(0.02)

    def spawned(self) -> int:
        with self.lock:
            return sum(len(v) for v in self.procs.values())

    def snapshot(self) -> dict:
        rounds = []
        for r in range(1, self.rendezvous.round_id + 1):
            spec = pickle.loads(self.kv.get(self.drv.ROUND_SPEC_KEY.format(r)))
            rounds.append((spec["round"], spec["world_size"],
                           [sorted(s.items()) for s in spec["slots"]]))
        notify = self.kv.get(self.drv.NOTIFY_KEY)
        res = self.driver.get_results()
        return {
            "rounds": rounds,
            "notify": None if notify is None else pickle.loads(notify),
            "spawns": sorted((k, len(v)) for k, v in self.procs.items()),
            "blacklisted": sorted(
                h for h in ("a", "b", "c", "d")
                if self.driver._host_manager.is_blacklisted(h)),
            "finished": self.driver.finished(),
            "succeeded": self.driver.succeeded,
            "error": res.error_message,
            "results": sorted((k, v[0]) for k, v in
                              res.worker_results.items()),
        }

    def stop(self):
        self.driver.stop()
        self.kv.stop()


def _run(pkg, scenario):
    """Run ``scenario`` (the harness's arguments, then its steps) on one
    package; the snapshot after each step."""
    (host_slots, min_np, max_np, kw), steps = scenario
    h = Harness(pkg, host_slots, min_np, max_np, **kw)
    snaps = []
    try:
        for step, *a in steps:
            if step == "start":
                h.driver.start(a[0], h.create_worker)
                h.until(lambda: h.spawned() >= a[1], f"{a[1]} spawns")
            elif step == "exit":
                (host, slot), code = a
                h.procs[(host, slot)][-1].exit(code)
            elif step == "hosts":
                h.discovery.set(a[0])
            elif step == "round":
                h.until(lambda: h.rendezvous.round_id >= a[0]
                        and h.spawned() >= a[1], f"round {a[0]}")
            elif step == "finished":
                h.until(h.driver.finished, "the job to stop")
            elif step == "peer_failure":
                h.driver.record_peer_failure(*a)
            elif step == "sleep":
                time.sleep(a[0])
            if step in ("start", "round", "finished", "sleep"):
                # after a wait only: the driver has acted on what came
                # before it
                snaps.append(h.snapshot())
    finally:
        h.stop()
    return snaps


SCENARIOS = {
    "initial_spawn": (({"a": 2, "b": 2}, 2, 4, {}), [("start", 2, 4)]),
    "success_stops": (({"a": 1}, 1, None, {}),
                      [("start", 1, 1), ("exit", ("a", 0), 0),
                       ("finished",)]),
    "failure_blacklists_and_resizes": (
        ({"a": 1, "b": 1}, 1, 2, {}),
        [("start", 2, 2), ("exit", ("b", 0), 1), ("round", 2, 2)]),
    "all_failures_stop": (({"a": 1}, 1, None, {}),
                          [("start", 1, 1), ("exit", ("a", 0), 1),
                           ("finished",)]),
    "host_added": (({"a": 1}, 1, 4, {}),
                   [("start", 1, 1), ("hosts", {"a": 1, "b": 1}),
                    ("round", 2, 2)]),
    "slot_lost_exit_ignored": (
        ({"a": 1, "b": 1}, 1, 2, {}),
        [("start", 2, 2), ("hosts", {"a": 1}), ("round", 2, 2),
         ("exit", ("b", 0), tdrv.SLOT_LOST_EXIT_CODE), ("sleep", 0.3)]),
    "scale_down_then_replace": (
        ({"a": 1, "b": 1}, 2, 2, {}),
        [("start", 2, 2), ("exit", ("b", 0), 1), ("sleep", 0.5),
         ("hosts", {"a": 1, "c": 1}), ("round", 2, 3)]),
    "reset_limit": (
        ({"a": 1, "b": 1, "c": 1}, 1, 3, {"reset_limit": 1}),
        [("start", 3, 3), ("exit", ("c", 0), 1), ("round", 2, 3),
         ("exit", ("b", 0), 1), ("finished",)]),
    "peer_failure_current_round": (
        ({"a": 1, "b": 1, "c": 1}, 1, 3, {}),
        [("start", 3, 3), ("peer_failure", 1, "silence", 1),
         ("round", 2, 3)]),
    "peer_failure_stale_round": (
        ({"a": 1, "b": 1}, 1, 2, {}),
        [("start", 2, 2), ("hosts", {"a": 1}), ("round", 2, 2),
         ("peer_failure", 1, "silence", 1), ("sleep", 0.3)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_driver_rounds_equal_jax(name):
    """The same scenario on both drivers: the same rounds (slot tables and
    world sizes), notifications, spawns, blacklist and results."""
    assert _run("torch", SCENARIOS[name]) == _run("jax", SCENARIOS[name])


def test_driver_defers_update_while_round_lock_held():
    h = Harness("torch", {"a": 1}, 1, 2)
    try:
        h.driver.start(1, h.create_worker)
        h.until(lambda: h.spawned() >= 1, "a spawn")
        assert h.driver._round_lock.acquire(timeout=5)
        try:
            t = threading.Thread(target=h.driver._on_hosts_updated,
                                 args=(tel.HostUpdateResult.added,))
            t.start()
            t.join(timeout=2.0)
            assert not t.is_alive(), "_on_hosts_updated blocked on the lock"
            assert h.driver._deferred_update == tel.HostUpdateResult.added
        finally:
            h.driver._round_lock.release()
    finally:
        h.stop()


def test_resume_after_shutdown_does_nothing():
    d = tdrv.ElasticDriver.__new__(tdrv.ElasticDriver)
    d._shutdown = threading.Event()
    d._shutdown.set()
    d.resume()


# --- discovery and the registry ------------------------------------------------

def _manager_trace(disc, steps, **kw):
    fixed = disc.FixedHosts(steps[0])
    mgr = disc.HostManager(fixed, **kw)
    out = []
    for hosts in steps:
        if isinstance(hosts, str):
            mgr.blacklist(hosts)
        else:
            fixed.set(hosts)
            out.append(int(mgr.update_available_hosts()))
        cur = mgr.current_hosts
        out.append((cur.host_assignment_order, cur.count_available_slots(),
                    sorted(cur.host_slots.items())))
    return out


@pytest.mark.parametrize("steps", [
    [{"a": 2}, {"a": 2, "b": 2}, {"b": 2}],
    [{"a": 1}, {"a": 4}, {"a": 4}, {"a": 2}],
    [{"a": 2, "b": 2}, "a", {"a": 2, "b": 2, "c": 1}],
    [{"c": 1, "a": 1}, {"c": 1, "a": 1, "b": 1}, {"b": 1, "d": 2}]])
def test_host_manager_equals_jax(steps):
    assert _manager_trace(tdisc, steps) == _manager_trace(jdisc, steps)


def test_host_order_and_cooldown_equal_jax(monkeypatch):
    assert tdisc.HostManager.order_available_hosts(
        {"c", "a", "b"}, ["b", "c"]) == jdisc.HostManager.\
        order_available_hosts({"c", "a", "b"}, ["b", "c"])
    for lo, hi in ((0.5, 2), (1, 7200)):
        with pytest.raises(ValueError) as j:
            jdisc.HostState((lo, hi))
        with pytest.raises(ValueError) as t:
            tdisc.HostState((lo, hi))
        assert str(t.value) == str(j.value)
    clock = [1000.0]
    for mod in (jdisc, tdisc):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
        monkeypatch.setattr(mod.random, "uniform", lambda a, b: 0.5)
    states = [mod.HostState((1, 60)) for mod in (jdisc, tdisc)]
    for s in states:
        s.blacklist()
    assert [s._cooldown_end_ts for s in states] == [1002.5, 1002.5]
    clock[0] = 1003.0
    assert [s.is_resurrected() for s in states] == [True, True]


@pytest.mark.parametrize("body", [
    "echo host-1:4\necho host-2\n", "echo a:2\necho a:2\necho\n",
    "exit 3\n"])
def test_discovery_script_equals_jax(tmp_path, body):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    out = []
    for disc in (jdisc, tdisc):
        try:
            out.append(disc.HostDiscoveryScript(
                str(script), default_slots=2).find_available_hosts_and_slots())
        except RuntimeError as e:
            out.append(str(e))
    assert out[0] == out[1]


class _StubDriver:
    def __init__(self):
        self.calls = []

    def finished(self):
        return any(c[0] == "stop" for c in self.calls)

    def stop(self, error_message=None, success=False):
        self.calls.append(("stop", error_message, success))

    def resume(self):
        self.calls.append(("resume",))


@pytest.mark.parametrize("records", [
    [("ready", "a", 0), ("ready", "a", 1)],
    [("success", "a", 0), ("failure", "a", 0)],
    [("ready", "a", 0), ("failure", "b", 0)],
    [("failure", "a", 0), ("failure", "b", 0)],
    [("failure", "b", 0), ("failure", "a", 0), ("success", "a", 0)],
    [("ready", "a", 0), ("success", "a", 0), ("ready", "a", 0)]])
@pytest.mark.parametrize("reset_limit", [None, 0])
def test_registry_decisions_equal_jax(records, reset_limit):
    out = []
    for el in (jel, tel):
        drv = _StubDriver()
        mgr = el.HostManager(el.FixedHosts({"a": 1, "b": 1}))
        mgr.update_available_hosts()
        reg = el.WorkerStateRegistry(drv, mgr, reset_limit=reset_limit)
        reg.reset(2)
        trace = []
        for kind, host, slot in records:
            getattr(reg, f"record_{kind}")(host, slot)
            trace.append((reg.count("READY"), reg.count("SUCCESS"),
                          reg.count("FAILURE"), reg.reset_count,
                          mgr.is_blacklisted("a"), mgr.is_blacklisted("b")))
        out.append((trace, drv.calls, reg.last_rendezvous()))
    assert out[0] == out[1]


# --- scripted churn and the membership actions ------------------------------------

@pytest.mark.parametrize("spec", [
    "worker:add:at_step=3:count=2;worker:remove:rank=1:at_step=5;"
    "worker:preempt:rank=2:at_step=7:grace=12.5",
    "worker:crash:rank=0:at_round=2", "kv.put:add:count=1",
    "worker:add:count=0", "worker:preempt:grace=-1",
    "worker:remove:at_round=3:after=1:times=2"])
def test_membership_grammar_equals_jax(spec):
    fields = ("site", "action", "rank", "times", "after", "at_step",
              "at_round", "count", "grace_s")
    out = []
    for faults in (jfaults, tfaults):
        try:
            out.append([[getattr(r, f) for f in fields]
                        for r in faults.parse_spec(spec)])
        except faults.FaultSpecError as e:
            out.append(str(e))
    assert out[0] == out[1]


@pytest.fixture
def fault_spec(monkeypatch):
    def install(spec):
        monkeypatch.setenv("HVD_FAULT_SPEC", spec)
        jfaults.refresh()
        tfaults.refresh()
    yield install
    monkeypatch.delenv("HVD_FAULT_SPEC", raising=False)
    for faults in (jfaults, tfaults):
        faults.refresh()
        faults.clear_membership_handler()


def test_step_and_round_filters_fire_as_jax(fault_spec, monkeypatch):
    fault_spec("worker:remove:at_round=3;worker:add:rank=1:at_step=2:"
               "count=2;worker:preempt:rank=0:at_step=4:times=2")
    fired = {"jax": [], "torch": []}
    for name, faults in (("jax", jfaults), ("torch", tfaults)):
        faults.set_membership_handler(
            lambda action, rule, name=name: fired[name].append(
                (action, rule.count)))
        assert faults.has_membership_rules()
    for rnd, rank, step in [(2, 0, 1), (3, 0, 1), (3, 0, 2), (1, 1, 2),
                            (1, 1, 2), (1, 0, 4), (2, 0, 4), (2, 0, 4)]:
        monkeypatch.setenv("HVD_ELASTIC_ROUND", str(rnd))
        jfaults.inject("worker", rank=rank, step=step)
        tfaults.inject("worker", rank=rank, step=step)
    assert fired["torch"] == fired["jax"] == [
        ("remove", 1), ("add", 2), ("preempt", 1), ("preempt", 1)]


def test_membership_without_handler_does_nothing(fault_spec):
    fault_spec("worker:add:count=1;kv.put:error:p=0.5")
    tfaults.clear_membership_handler()
    tfaults.inject("worker", rank=0, step=1)
    fault_spec("kv.put:error:p=0.5")
    assert not tfaults.has_membership_rules()


class _GraceDriver:
    def __init__(self):
        self.grace = []

    def set_stale_grace(self, host, seconds):
        self.grace.append((host, seconds))


def test_scripted_churn_equals_jax(monkeypatch):
    out = []
    for disc, faults in ((jdisc, jfaults), (tdisc, tfaults)):
        fixed = disc.FixedHosts({"h0": 1, "h1": 1})
        events = []
        churn = disc.ScriptedChurn(fixed, events=events)
        drv = _GraceDriver()
        churn.attach_driver(drv)
        trace = []
        for action, host, spec in [
                ("add", "h0", "worker:add:count=2"),
                ("add", "h0", "worker:add:count=1"),
                ("preempt", "churn0", "worker:preempt:grace=7"),
                ("remove", "h1", "worker:remove")]:
            monkeypatch.setenv("HVD_HOSTNAME", host)
            (rule,) = faults.parse_spec(spec)
            churn(action, rule)
            trace.append(sorted(fixed.find_available_hosts_and_slots()))
        out.append((trace, drv.grace, [(a, h) for _t, a, h in events]))
    assert out[0] == out[1]


def test_scripted_add_readmits_the_hosts_churn_took_out(monkeypatch):
    """The port's ``add`` brings back the hosts an earlier ``remove`` or
    ``preempt`` took out, oldest first and with their slots, before it
    mints names (a process world can start no worker on a minted name);
    where none left, it mints them as the JAX package does."""
    fixed = tdisc.FixedHosts({"localhost": 2, "127.0.0.1": 2, "c": 1})
    churn = tdisc.ScriptedChurn(fixed)
    for action, host, spec in [("remove", "127.0.0.1", "worker:remove"),
                               ("preempt", "c", "worker:preempt"),
                               ("add", "localhost", "worker:add:count=1")]:
        monkeypatch.setenv("HVD_HOSTNAME", host)
        (rule,) = tfaults.parse_spec(spec)
        churn(action, rule)
    assert fixed.find_available_hosts_and_slots() == {"localhost": 2,
                                                      "127.0.0.1": 2}
    (add,) = tfaults.parse_spec("worker:add:count=2")
    churn("add", add)
    assert fixed.find_available_hosts_and_slots() == {
        "localhost": 2, "127.0.0.1": 2, "c": 1, "churn0": 1}
    assert [e[1:] for e in churn.events] == [
        ("remove", "127.0.0.1"), ("preempt", "c"), ("add", "127.0.0.1"),
        ("add", "c,churn0")]


def test_churn_reaches_the_driver_over_the_kv_store():
    """A worker's membership action goes over the launcher's KV store to
    the job's ScriptedChurn (the bootstrap's PUT observer)."""
    from horovod_tpu_torch.elastic.bootstrap import make_elastic_infra
    fixed = tdisc.FixedHosts({"localhost": 1, "127.0.0.1": 1})
    infra = make_elastic_infra(fixed, 1, 2, timeout=WAIT_S)
    try:
        churn = tdisc.ScriptedChurn(fixed)
        drv = _GraceDriver()
        churn.attach_driver(drv)
        infra.churn = churn
        client = tkv.KVClient("127.0.0.1", infra.kv_port,
                              secret=infra.secret)
        relay = tdisc.KVChurnRelay(client, "127.0.0.1")
        (pre,) = tfaults.parse_spec("worker:preempt:grace=9")
        relay("preempt", pre)
        (add,) = tfaults.parse_spec("worker:add:count=2")
        relay("add", add)
        # the preempted host comes back first, then a minted name
        assert fixed.find_available_hosts_and_slots() == {
            "localhost": 1, "127.0.0.1": 1, "churn0": 1}
        assert drv.grace == [("127.0.0.1", 9.0)]
        assert [e[1] for e in churn.events] == ["preempt", "add"]
        assert tdisc.parse_churn(b"{not json") is None
    finally:
        infra.stop()


def test_install_scripted_churn_equals_jax(fault_spec, tmp_path):
    fault_spec("worker:add:count=1")
    script = tmp_path / "d.sh"
    script.write_text("#!/bin/sh\necho a\n")
    for disc in (jdisc, tdisc):
        assert disc.install_scripted_churn(
            disc.HostDiscoveryScript(str(script))) is None
        churn = disc.install_scripted_churn(disc.FixedHosts({"a": 1}))
        assert isinstance(churn, disc.ScriptedChurn)
    fault_spec("kv.put:error")
    assert tdisc.install_scripted_churn(tdisc.FixedHosts({"a": 1})) is None


# --- the KV protocol, peer-failure records, the worker's rendezvous -----------

def test_key_layout_equals_jax():
    for name in ("ROUND_KEY", "ROUND_SPEC_KEY", "NOTIFY_KEY", "STOP_KEY",
                 "READY_KEY_PREFIX", "DONE_KEY_PREFIX",
                 "SLOT_LOST_EXIT_CODE"):
        assert getattr(tdrv, name) == getattr(jdrv, name), name
    assert tnote.NOTIFY_KEY == jdrv.NOTIFY_KEY
    for key in (tdrv.ready_key(3, "h", 1), tdrv.done_key("h", 2),
                "elastic/ready/1/h/x", "elastic/done/h", "other"):
        assert tdrv.parse_ready_key(key) == jdrv.parse_ready_key(key)
        assert tdrv.parse_done_key(key) == jdrv.parse_done_key(key)
    assert tdrv.ready_key(3, "h", 1) == jdrv.ready_key(3, "h", 1)


@pytest.mark.parametrize("key,payload", [
    ("health/peerfail/2", b'{"dead_rank": 1, "reason": "silence", '
                          b'"round": 3}'),
    ("health/peerfail/0", b'{"dead_rank": 4}'),
    ("health/peerfail/0", b'{"reason": "x"}'), ("health/peerfail/0", b"\xff"),
    ("elastic/ready/1/h/0", b"1")])
def test_peer_failure_records_equal_jax(key, payload):
    assert thealth.parse_peer_failure(key, payload) == \
        jhealth.parse_peer_failure(key, payload)
    assert thealth.peer_failure_key(5) == jhealth.peer_failure_key(5)


def test_watchdog_budget_equals_jax(monkeypatch):
    monkeypatch.setenv("HVD_HEALTH_INTERVAL", "0.3")
    monkeypatch.setenv("HVD_HEALTH_TIMEOUT", "4")
    assert thealth.watchdog_budget_s() == jhealth.watchdog_budget_s() == 4.3


def test_watchdog_reports_a_death_to_the_driver(monkeypatch):
    """An elastic worker's watchdog PUTs the death where the driver's
    observer parses it; a rank that left on purpose is not reported."""
    monkeypatch.setenv("HVD_ELASTIC", "1")
    monkeypatch.setenv("HVD_ELASTIC_ROUND", "4")
    server = tkv.KVServer(secret="s")
    port = server.start()
    try:
        client = tkv.KVClient("127.0.0.1", port, secret="s")
        wd = thealth.HealthWatchdog(client, 3, 0, "engine/x/health",
                                    on_failure=lambda r, why: None)
        wd._left.add(2)
        wd._decide(1, "no liveness beat")
        assert thealth.parse_peer_failure(
            thealth.peer_failure_key(0),
            server.get(thealth.peer_failure_key(0))) == (
                1, "no liveness beat", 4)
        assert wd.peer_left(2) and not wd.peer_left(1)
        server.delete(thealth.peer_failure_key(0))
        wd._failed = None
        wd._decide(2, "left the world")
        assert server.get(thealth.peer_failure_key(0)) is None
    finally:
        server.stop()


def test_worker_rendezvous_follows_the_rounds(monkeypatch):
    """The worker's side of the protocol on a live KV store, for both
    packages: it waits for a round past its own, finds its slot, seeds
    the same ``HVD_*`` contract (the port adds torch's), records its
    readiness, and exits with the slot-lost code where its slot is
    gone."""
    from horovod_tpu import engine_service as jes
    from horovod_tpu.runner import hosts as jhosts
    from horovod_tpu_torch import engine_service as tes
    from horovod_tpu_torch.runner import hosts as thosts
    contract = ("HVD_RANK", "HVD_SIZE", "HVD_ELASTIC_ROUND",
                "HVD_COORDINATOR_ADDR", "HVD_COORDINATOR_PORT",
                "HVD_LOCAL_RANK", "HVD_LOCAL_SIZE", "HVD_CROSS_RANK",
                "HVD_CROSS_SIZE", "HVD_PROCESS_ID", "HVD_NUM_PROCESSES",
                "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")
    saved = dict(os.environ)
    seeded = []
    try:
        for drv, rdv, hosts, kv, es in (
                (jdrv, jrdv, jhosts, jkv, jes),
                (tdrv, trdv, thosts, tkv, tes)):
            for k in contract:
                os.environ.pop(k, None)
            os.environ.update(HVD_HOSTNAME="b", HVD_ELASTIC_TIMEOUT="5")
            monkeypatch.setattr(es, "mark_leaving", lambda: None)
            server = kv.KVServer()
            server.start()
            try:
                pub = drv.ElasticRendezvous(server)
                pub.publish_round(hosts.get_host_assignments(
                    hosts.parse_hosts("a:1,b:1"), 2), "10.0.0.1", 1111,
                    tel.HostUpdateResult.added)
                w = rdv.WorkerRendezvous(kv_client=server)
                assert (w.hostname, w.slot, w.round) == ("b", 0, 1)
                pub.publish_round(hosts.get_host_assignments(
                    hosts.parse_hosts("b:1"), 1), "10.0.0.2", 2222,
                    tel.HostUpdateResult.removed)
                spec = w._wait_for_next_round()
                w._seed_round_env(spec, w._find_my_slot(spec))
                seeded.append({k: os.environ.get(k) for k in contract})
                w.round = spec["round"]
                w.record_ready()
                assert server.get(drv.ready_key(2, "b", 0)) == b"1"
                pub.publish_round(hosts.get_host_assignments(
                    hosts.parse_hosts("a:1"), 1), "10.0.0.3", 3333,
                    tel.HostUpdateResult.removed)
                with pytest.raises(SystemExit) as exit_:
                    w.reset()
                assert exit_.value.code == drv.SLOT_LOST_EXIT_CODE
            finally:
                server.stop()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    jax_env, torch_env = seeded
    assert {k: v for k, v in torch_env.items() if k.startswith("HVD_")} == \
        {k: v for k, v in jax_env.items() if k.startswith("HVD_")}
    assert [torch_env[k] for k in contract if not k.startswith("HVD_")] == [
        "0", "1", "0", "1", "10.0.0.2", "2222"]


def test_worker_rendezvous_refuses_a_static_launch(monkeypatch):
    monkeypatch.setenv("HVD_KV_ADDR", "127.0.0.1")
    monkeypatch.delenv("HVD_ELASTIC", raising=False)
    with pytest.raises(RuntimeError, match="not an elastic worker"):
        trdv.WorkerRendezvous()


# --- the negotiation service's warm re-form ----------------------------------

def _warm_reform_trace(es, dyn, kv, rcache, metrics) -> tuple:
    """Two services (one member each) over a KV server, as a world of two
    and then, after both stopped on purpose, as a re-formed world of the
    same shape: for each of four calls of one named allreduce request in
    each world, whether it was served from the coordinator cache; the
    response entries the warm round confirmed."""
    import threading
    rcache.clear_shelf()
    before = sum(v for k, v in metrics.ELASTIC_WARM_REUSE.series().items()
                 if dict(k).get("kind") == "response")
    server = kv.KVServer(secret="warm")
    port = server.start()
    req = dict(name="loss", request_type=dyn.REQ_ALLREDUCE, shape=(16,),
               dtype=11, element_size=4)
    trace = []
    try:
        for world in ("world1", "world2"):
            svcs = [es.DynamicService(
                dyn.NativeEngine(world_size=2, rank=r),
                es.KVTransport(kv.KVClient("127.0.0.1", port,
                                           secret="warm"), 2, r,
                               prefix=world)) for r in range(2)]
            try:
                served = []
                for _ in range(4):
                    got = [None, None]

                    def call(i):
                        t = svcs[i].negotiate_many_submit([dict(req)])
                        svcs[i].negotiate_many_wait(t, timeout=60.0)
                        got[i] = t.served

                    threads = [threading.Thread(target=call, args=(i,))
                               for i in range(2)]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(60)
                    served.append(tuple(got))
                trace.append(served)
            finally:
                for s in svcs:
                    s.stop()
    finally:
        server.stop()
        rcache.clear_shelf()
    after = sum(v for k, v in metrics.ELASTIC_WARM_REUSE.series().items()
                if dict(k).get("kind") == "response")
    return trace, after - before


def test_service_warm_reform_equals_jax(monkeypatch):
    """The coordinator cache across a re-form, in both packages: the
    first world serves its request from the third call (populate, then
    confirm); the services stopped on purpose shelve their entries, the
    re-formed world of the same shape restores them warm, one digest
    round confirms them, and the request is served from the second call."""
    from horovod_tpu import dynamic as jdyn
    from horovod_tpu import engine_service as jes
    from horovod_tpu import metrics as jmetrics
    from horovod_tpu.negotiation import response_cache as jrc
    from horovod_tpu_torch import dynamic as tdyn
    from horovod_tpu_torch import engine_service as tes
    from horovod_tpu_torch import metrics as tmetrics
    from horovod_tpu_torch.negotiation import response_cache as trc
    monkeypatch.setenv("HVD_RESPONSE_CACHE", "1")
    monkeypatch.setenv("HVD_ELASTIC_WARM", "1")
    monkeypatch.setenv("HVD_HEALTH_INTERVAL", "0")
    got = _warm_reform_trace(tes, tdyn, tkv, trc, tmetrics)
    want = _warm_reform_trace(jes, jdyn, jkv, jrc, jmetrics)
    assert got == want
    (cold, warm), confirmed = got
    assert confirmed == 2  # one entry, on each of the two members
    assert cold.index((True, True)) == 2 and warm.index((True, True)) == 1
