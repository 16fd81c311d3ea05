"""The port's observability modules against the JAX package's: the
metrics registry and its ``/metrics`` exposition, fault injection, the
retry ladder, the conformance recorder, the health watchdog and straggler
tracker, and the timeline.

Where a comparison is of names, bytes, decisions or counters it is exact;
the watchdog's timings are checked against the timeouts they are set to.
The timeline's world of two runs the rank side of
``test_torch_negotiation.py`` (no JAX).
"""

import json
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from horovod_tpu import conformance as jconf
from horovod_tpu import health as jhealth
from horovod_tpu import metrics as jmetrics
from horovod_tpu import timeline as jtimeline
from horovod_tpu.negotiation import GroupLayout as JGroupLayout
from horovod_tpu.utils import faults as jfaults
from horovod_tpu.utils import retry as jretry

from horovod_tpu_torch import conformance as tconf
from horovod_tpu_torch import health as thealth
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import timeline as ttimeline
from horovod_tpu_torch.negotiation import GroupLayout as TGroupLayout
from horovod_tpu_torch.utils import faults as tfaults
from horovod_tpu_torch.utils import retry as tretry
from test_torch_negotiation import TIMELINE_NAMES
from test_torch_negotiation_cache import _DictKV
from test_torch_world2 import REPO, run_world


# --------------------------------------------------------------------------
# (i) the metrics registry
# --------------------------------------------------------------------------

# the port's instruments that mirror the JAX package's (the port's own,
# ``tmetrics.PORT_ONLY``, have no counterpart there)
PORT_CATALOG = sorted(set(tmetrics.instruments()) - tmetrics.PORT_ONLY)


@pytest.fixture
def clean_metrics(monkeypatch):
    """The port's catalog's series dropped in both registries, before and
    after; no launcher rank unless a test sets one."""
    for name in ("HVD_RANK", "HOROVOD_RANK", "RANK"):
        monkeypatch.delenv(name, raising=False)

    def drop():
        tmetrics.reset()
        jmetrics.reset_all(*(jmetrics.instruments()[n]
                             for n in PORT_CATALOG))

    drop()
    yield
    drop()


def _record_events(m) -> None:
    """The same events into either registry: every instrument of the
    port's catalog, with labels, values past the last bucket included."""
    for i, s in enumerate((0.004, 0.03, 0.7, 12.0)):
        m.NEGOTIATION_ROUNDS.inc(labels={"process_set": "global"})
        m.NEGOTIATION_ROUND_SECONDS.observe(s, labels={"process_set":
                                                       "global"})
        m.NEGOTIATION_SUBMIT_LAG.observe(s / 3, labels={"rank": i % 2})
    m.NEGOTIATION_ROUNDS.inc(2, labels={"process_set": "7"})
    m.STRAGGLER_ROUNDS.inc(labels={"rank": 1})
    m.RESPONSE_CACHE_HITS.bind({"process_set": "global"}).inc(5)
    m.RESPONSE_CACHE_MISSES.inc(2, labels={"process_set": "global"})
    for op, k in (("put", 3), ("get", 1), ("gather", 4), ("delete", 2)):
        m.KV_OPS.inc(k, labels={"op": op})
    m.RETRY_RETRIES.inc(labels={"site": "kv.put"})
    m.RETRY_GIVEUPS.inc(labels={"site": "kv.gather"})
    m.HEALTH_BEATS.inc(7)
    m.HEALTH_BEAT_ERRORS.inc()
    m.HEALTH_PEER_FAILURES.inc(labels={"rank": 2})
    m.FAULT_FIRES.inc(labels={"site": "svc.exchange"})


def _catalog_lines(text: str) -> list[str]:
    """The lines of a ``/metrics`` payload that name the port's catalog."""
    return [ln for ln in text.splitlines()
            if re.split(r"[ {]", ln.removeprefix("# HELP ")
                        .removeprefix("# TYPE "))[0]
            .removesuffix("_bucket").removesuffix("_sum")
            .removesuffix("_count") in PORT_CATALOG]


def test_catalog_is_a_subset_of_jax():
    jcat = jmetrics.instruments()
    for name in PORT_CATALOG:
        inst, ref = tmetrics.instruments()[name], jcat[name]
        assert (inst.kind, inst.help, inst.labelnames, inst.always) == (
            ref.kind, ref.help, ref.labelnames, ref.always), name
        assert getattr(inst, "buckets", None) == getattr(ref, "buckets",
                                                         None)


@pytest.mark.parametrize("rank", [None, "3"])
def test_prometheus_text_equals_jax(clean_metrics, monkeypatch, rank):
    """The same events give the same ``/metrics`` lines: every series'
    name, labels (the launcher rank as ``rank``, or as ``reporter`` where
    a series names a rank of its own) and value, and each instrument's
    HELP and TYPE."""
    if rank is not None:
        monkeypatch.setenv("HVD_RANK", rank)
    _record_events(tmetrics)
    _record_events(jmetrics)
    got = _catalog_lines(tmetrics.prometheus_text())
    want = _catalog_lines(jmetrics.prometheus_text())
    assert got == want
    assert len([ln for ln in got if not ln.startswith("#")]) > 40
    if rank is not None:
        assert 'hvd_straggler_rounds_total{rank="1",reporter="3"} 1' in got


def test_dump_snapshot_delta_equal_jax(clean_metrics):
    t0, j0 = tmetrics.snapshot(), jmetrics.snapshot()
    _record_events(tmetrics)
    _record_events(jmetrics)
    tdump = {k: v for k, v in tmetrics.dump().items() if k in PORT_CATALOG}
    jdump = {k: v for k, v in jmetrics.dump(all_worlds=True).items()
             if k in PORT_CATALOG}
    assert tdump == jdump
    names = set(PORT_CATALOG) | {n + s for n in PORT_CATALOG
                                 for s in ("_sum", "_count")}
    tdelta = {k: v for k, v in tmetrics.delta(tmetrics.snapshot(),
                                              t0).items() if k[0] in names}
    jdelta = {k: v for k, v in jmetrics.delta(jmetrics.snapshot(),
                                              j0).items() if k[0] in names}
    assert tdelta == jdelta


def test_labels_are_checked_as_jax(clean_metrics):
    for m in (tmetrics, jmetrics):
        with pytest.raises(ValueError, match="requires labels"):
            m.KV_OPS.inc()
        with pytest.raises(ValueError, match="!= declared"):
            m.KV_OPS.inc(labels={"verb": "put"})
        with pytest.raises(ValueError, match="already registered"):
            m.counter("hvd_kv_ops_total", "again")


def test_metrics_off_records_only_always(clean_metrics):
    tmetrics.set_enabled(False)
    try:
        _record_events(tmetrics)
        assert tmetrics.KV_OPS.series() == {}
        assert tmetrics.RETRY_RETRIES.value({"site": "kv.put"}) == 1
    finally:
        tmetrics.set_enabled(None)
    assert tmetrics.enabled()


def test_kv_server_and_worker_serve_the_same_series(clean_metrics,
                                                    monkeypatch):
    """``GET /metrics`` of the port's KV server (unsigned) and of the
    per-worker server on ``HVD_METRICS_PORT`` + rank both answer with the
    registry's payload, which names the JAX registry's series."""
    from horovod_tpu_torch.runner.http_kv import KVServer, make_secret
    _record_events(tmetrics)
    _record_events(jmetrics)
    want = _catalog_lines(jmetrics.prometheus_text())
    server = KVServer(secret=make_secret(), host="127.0.0.1")
    port = server.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            kv_text = resp.read().decode()
    finally:
        server.stop()
    assert _catalog_lines(kv_text) == want
    from test_torch_world2 import _free_port
    base = _free_port()
    monkeypatch.setenv("HVD_METRICS_PORT", str(base))
    monkeypatch.setenv("RANK", "0")
    try:
        bound = tmetrics.maybe_serve()
        assert bound == base and tmetrics.serve() == base  # idempotent
        with urllib.request.urlopen(f"http://127.0.0.1:{base}/metrics",
                                    timeout=10) as resp:
            worker_text = resp.read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{base}/other",
                                   timeout=10)
    finally:
        tmetrics.stop_serving()
    assert len(_catalog_lines(worker_text)) == len(want)


def test_kv_client_counts_its_operations(clean_metrics):
    from horovod_tpu_torch.runner.http_kv import (KVClient, KVServer,
                                                  make_secret)
    server = KVServer(secret=make_secret(), host="127.0.0.1")
    port = server.start()
    try:
        kv = KVClient("127.0.0.1", port, secret=server.secret)
        kv.put("s/a", b"1")
        kv.get("s/a")
        kv.gather("s", 1, timeout=5)
        kv.delete("s/a")
    finally:
        server.stop()
    ops = {dict(k)["op"]: v for k, v in tmetrics.KV_OPS.series().items()}
    assert ops == {"put": 1, "get": 1, "gather": 1, "delete": 1}


# --------------------------------------------------------------------------
# fault injection
# --------------------------------------------------------------------------

@pytest.fixture
def fault_spec(monkeypatch):
    """Install ``HVD_FAULT_SPEC`` in both packages; off again after."""
    def install(text):
        monkeypatch.setenv("HVD_FAULT_SPEC", text)
        tfaults.refresh()
        jfaults.refresh()

    yield install
    monkeypatch.delenv("HVD_FAULT_SPEC", raising=False)
    tfaults.refresh()
    jfaults.refresh()


RULE_FIELDS = ("site", "action", "delay_s", "exit_code", "p", "seed",
               "after", "times", "rank")


@pytest.mark.parametrize("spec", [
    "kv.put:error:p=0.2:seed=7",
    "svc.exchange:delay=0.05:rank=2",
    "svc.submit:crash:rank=1:after=5",
    "kv.*:error:times=3;svc.submit:crash:code=3",
    " kv.get:delay=1.5:after=2:times=1 ; ",
])
def test_spec_grammar_equals_jax(spec):
    got = [{f: getattr(r, f) for f in RULE_FIELDS}
           for r in tfaults.parse_spec(spec)]
    want = [{f: getattr(r, f) for f in RULE_FIELDS}
            for r in jfaults.parse_spec(spec)]
    assert got == want


@pytest.mark.parametrize("spec", [
    "", "kv.put", ":error", "kv.put:delay=x",
    "kv.put:error:p=2", "kv.put:error:p=x", "kv.put:error:after",
    "kv.put:error:colour=red"])
def test_bad_specs_raise_as_jax(spec):
    with pytest.raises(tfaults.FaultSpecError) as t:
        tfaults.parse_spec(spec)
    with pytest.raises(jfaults.FaultSpecError) as j:
        jfaults.parse_spec(spec)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("spec", ["worker:add", "worker:crash:at_step=3",
                                  "svc.submit:error:at_round=1",
                                  "kv.put:explode"])
def test_elastic_rules_are_refused(spec):
    """Membership actions and the step and round filters, refused until
    the port had its elastic layer, now parse as the JAX package's; an
    unknown action is refused with the JAX package's message."""
    try:
        want = jfaults.parse_spec(spec)
    except jfaults.FaultSpecError as e:
        with pytest.raises(tfaults.FaultSpecError) as t:
            tfaults.parse_spec(spec)
        assert str(t.value) == str(e)
        return
    fields = ("site", "action", "rank", "times", "at_step", "at_round",
              "count", "grace_s", "exit_code")
    got = tfaults.parse_spec(spec)
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]


def _fire_pattern(faults, site, calls, rank=None) -> list:
    out = []
    for _ in range(calls):
        try:
            faults.inject(site, rank=rank)
            out.append(0)
        except faults.FaultInjected as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("spec,site,rank", [
    ("kv.put:error:p=0.3:seed=7", "kv.put", None),
    ("kv.*:error:after=3:times=4", "kv.gather", None),
    ("svc.submit:error:rank=1:after=2", "svc.submit", 1),
    ("svc.submit:error:rank=1", "svc.submit", 0),
])
def test_fire_pattern_equals_jax(fault_spec, clean_metrics, spec, site,
                                 rank):
    """The seeded draw and the filters fire the same calls in both."""
    fault_spec(spec)
    got = _fire_pattern(tfaults, site, 40, rank)
    want = _fire_pattern(jfaults, site, 40, rank)
    assert got == want
    assert tfaults.stats() == jfaults.stats()
    fires = sum(1 for x in got if x)
    assert tmetrics.FAULT_FIRES.value({"site": site}) == fires


def test_delay_and_crash_actions(fault_spec, monkeypatch):
    fault_spec("svc.exchange:delay=0.2:times=1;svc.submit:crash:code=7")
    t0 = time.monotonic()
    tfaults.inject("svc.exchange")
    assert time.monotonic() - t0 >= 0.2
    tfaults.inject("svc.exchange")  # times=1: no second sleep
    codes = []
    monkeypatch.setattr(tfaults, "_crash", codes.append)
    tfaults.inject("svc.submit")
    assert codes == [7] and tfaults.active()


def test_no_spec_is_off(fault_spec, monkeypatch):
    monkeypatch.delenv("HVD_FAULT_SPEC", raising=False)
    tfaults.refresh()
    assert not tfaults.active() and tfaults.stats() == {}
    tfaults.inject("kv.put")


def test_injected_kv_faults_retry_as_flaps(fault_spec, clean_metrics,
                                          monkeypatch):
    """An injected ``kv.put`` error is a transport failure: the client's
    retry ladder absorbs two, counting them."""
    from horovod_tpu_torch.runner.http_kv import (KVClient, KVServer,
                                                  make_secret)
    monkeypatch.setenv("HVD_RETRY_BACKOFF_MS", "1")
    fault_spec("kv.put:error:times=2")
    server = KVServer(secret=make_secret(), host="127.0.0.1")
    port = server.start()
    try:
        KVClient("127.0.0.1", port, secret=server.secret).put("k", b"v")
        assert server.get("k") == b"v"
    finally:
        server.stop()
    assert tretry.stats() == {"kv.put": {"retries": 2, "giveups": 0}}


# --------------------------------------------------------------------------
# the retry ladder
# --------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    {}, {"HVD_RETRY_JITTER": "0"},
    {"HVD_RETRY_BACKOFF_MS": "10", "HVD_RETRY_MAX_BACKOFF_MS": "35",
     "HVD_RETRY_JITTER": "0.5"}])
def test_backoff_schedule_equals_jax(monkeypatch, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    for site in ("kv.put", "kv.gather", "health.beat"):
        for attempt in range(1, 9):
            assert (tretry.backoff_s(site, attempt)
                    == jretry.backoff_s(site, attempt))
    assert tretry.max_attempts() == jretry.max_attempts()


def _retry_run(retry, outcomes, **kw):
    """``retry.call`` over a function failing as ``outcomes`` says."""
    it = iter(outcomes)

    def fn():
        o = next(it)
        if o == "ok":
            return "done"
        raise (ConnectionError if o == "flap" else KeyError)(o)

    try:
        return retry.call(fn, what=kw.pop("what", "site"), **kw)
    except Exception as e:  # the outcome is the observation
        return type(e).__name__


@pytest.mark.parametrize("outcomes,kw", [
    (["flap", "flap", "ok"], {}),
    (["flap"] * 5, {}),
    (["flap", "bad", "ok"], {"retry_on": (ConnectionError,)}),
    (["flap", "flap", "ok"], {"retry_on": lambda e: False}),
    (["flap"] * 3, {"attempts": 2}),
])
def test_retry_call_equals_jax(monkeypatch, clean_metrics, outcomes, kw):
    monkeypatch.setenv("HVD_RETRY_BACKOFF_MS", "1")
    tretry.reset_stats()
    jretry.reset_stats()
    assert _retry_run(tretry, outcomes, **dict(kw)) == _retry_run(
        jretry, outcomes, **dict(kw))
    assert tretry.stats() == jretry.stats()


def test_retry_deadline_gives_up_as_jax(monkeypatch, clean_metrics):
    monkeypatch.setenv("HVD_RETRY_BACKOFF_MS", "50")
    for retry in (tretry, jretry):
        retry.reset_stats()
        assert _retry_run(retry, ["flap"] * 5,
                          deadline_s=0.01) == "ConnectionError"
        assert retry.stats() == {"site": {"retries": 0, "giveups": 1}}


def test_poll_intervals_stop_at_the_deadline():
    t0 = time.monotonic()
    got = list(tretry.poll_intervals("kv.wait", interval_s=0.001,
                                     deadline_s=0.3))
    assert 0.3 <= time.monotonic() - t0 < 2.0
    assert got == list(range(1, len(got) + 1)) and len(got) > 10


# --------------------------------------------------------------------------
# the conformance recorder
# --------------------------------------------------------------------------

@pytest.fixture
def recorders():
    for m in (tconf, jconf):
        m.set_enabled(True)
        m.reset()
    yield
    for m in (tconf, jconf):
        m.set_enabled(None)
        m.reset()


EVENTS = [
    ("engine_service.py::DynamicService.__init__", "svc_start",
     ("global", 4, 1)),
    ("negotiation/response_cache.py::ResponseCache.note_response",
     "confirm", ("global", "loss")),
    ("negotiation/response_cache.py::ResponseCache.count_served",
     "served", ("global", 1, 1)),
    ("negotiation/response_cache.py::ResponseCache.restore_warm",
     "warm_restore", ("global", 2)),
    ("negotiation/response_cache.py::ResponseCache.count_served",
     "served", ("global", 3, 2)),
    ("engine_service.py::DynamicService.join", "join", ("global", "j")),
    ("engine_service.py::DynamicService.stop", "svc_stop", ("global",)),
]


def test_port_sites_are_the_references():
    for site, cls in tconf.SITES.items():
        assert jconf.SITES[site] == cls, site
    assert tconf.TRACE_SCHEMA == jconf.TRACE_SCHEMA


def test_recorder_chains_equal_jax(recorders, monkeypatch):
    """The same decisions give the same chains and event rows, the
    knob-override epoch moves included."""
    from horovod_tpu.utils import envs as jenvs
    from horovod_tpu_torch.utils import envs as tenvs
    for e in (tenvs, jenvs):  # the epoch moves' payloads count from 0
        monkeypatch.setattr(e, "_override_epoch", 0)
    for m, e in ((tconf, tenvs), (jconf, jenvs)):
        for i, (site, kind, payload) in enumerate(EVENTS):
            if i == 3:
                e.set_override("CYCLE_TIME", "33")
            m.record(site, kind, payload)
        e.clear_override("CYCLE_TIME")
    t, j = tconf.conformance_dump(), jconf.conformance_dump()
    assert t["chains"] == {k: j["chains"][k] for k in tconf.STREAMS}
    assert not any(v for k, v in j["chains"].items()
                   if k not in tconf.STREAMS)
    assert t["events"] == j["events"]
    assert t["ring"] == j["ring"] and t["n_events"] == j["n_events"] == 8
    stats = tconf.conformance_stats()
    assert stats["events"] == 8 and stats["by_stream"]["rcache"] == 4


def test_traces_pass_hvdtrace_and_it_finds_divergence(recorders,
                                                      tmp_path,
                                                      monkeypatch):
    """Two ranks' traces of the same decisions diff clean; a rank that
    serves another batch is the divergence ``tools.hvdtrace`` names, and a
    serve after a join breaks the protocol's state machine."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")

    def trace(rank, events, d):
        monkeypatch.setenv("RANK", str(rank))
        tconf.reset()
        for ev in events:
            tconf.record(*ev)
        return tconf.conformance_dump(str(d / f"hvdtrace-r{rank}.json"))

    def check(d):
        res = subprocess.run([sys.executable, "-m", "tools.hvdtrace",
                              "--json", str(d)], cwd=REPO,
                             capture_output=True, text=True, timeout=60)
        return res.returncode, json.loads(res.stdout)

    ok = tmp_path / "ok"
    for r in (0, 1):
        doc = trace(r, EVENTS[:5] + EVENTS[6:], ok)
        assert doc["label"] == f"rank{r}" and doc["size"] == 2
    rc, report = check(ok)
    assert rc == 0 and report["clean"], report
    bad = tmp_path / "bad"
    trace(0, EVENTS[:5], bad)
    trace(1, EVENTS[:4] + [(EVENTS[4][0], "served", ("global", 2, 2))],
          bad)
    rc, report = check(bad)
    assert rc == 1 and report["summary"]["divergences"] == 1
    assert report["findings"][0]["stream"] == "rcache"
    late = tmp_path / "late"
    for r in (0, 1):
        trace(r, EVENTS, late)  # a serve after the join
        tconf.record(*EVENTS[2])
        tconf.conformance_dump(str(late / f"hvdtrace-r{r}.json"))
    rc, report = check(late)
    assert rc == 1 and report["summary"]["fsm_violations"] == 2


def test_maybe_dump_writes_at_shutdown_only_when_asked(recorders, tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("HVD_CONFORMANCE_DIR", raising=False)
    assert tconf.maybe_dump("shutdown") is None  # nothing recorded
    tconf.record(*EVENTS[0])
    assert tconf.maybe_dump("shutdown") is None  # no directory
    monkeypatch.setenv("HVD_CONFORMANCE_DIR", str(tmp_path))
    first = tconf.maybe_dump("shutdown")
    second = tconf.maybe_dump("shutdown")
    assert first != second and second.endswith("-d1.json")
    assert json.loads(open(first).read())["dump_reason"] == "shutdown"
    tconf.set_enabled(False)
    tconf.record(*EVENTS[1])
    assert tconf.conformance_stats()["events"] == 1


# --------------------------------------------------------------------------
# the health watchdog and the straggler tracker
# --------------------------------------------------------------------------

def _watch(health, layout_cls, world, scenario, layout_g=None):
    """``world`` watchdogs over one in-memory store (interval 0.1 s,
    timeout 2.5 s); ``scenario(dogs)`` acts once all have beaten.
    Returns each survivor's decisions: (dead rank, reason's first words)."""
    kv = _DictKV()
    calls = {r: [] for r in range(world)}
    layout = layout_cls(world, layout_g) if layout_g else None
    dogs = [health.HealthWatchdog(
        kv, world, r, "engine/health",
        on_failure=lambda d, why, r=r: calls[r].append(
            (d, " ".join(why.split()[:3]))),
        interval_s=0.1, timeout_s=2.5, layout=layout)
        for r in range(world)]
    for d in dogs:
        d.start()
    deadline = time.monotonic() + 20
    while not all(all(s is not None for s in d.last_seen().values())
                  for d in dogs):
        assert time.monotonic() < deadline
        time.sleep(0.02)
    gone = scenario(dogs)
    while not all(calls[r] for r in range(world) if r not in gone):
        assert time.monotonic() < deadline, calls
        time.sleep(0.02)
    time.sleep(0.3)  # a second decision would land here
    for d in dogs:
        d.stop()
    return {r: c for r, c in calls.items() if r not in gone}


def _silent(dogs):
    dogs[2].stop(join=False)
    return {2}


def _poisoned(dogs):
    dogs[1].poison("engine cycle failed: boom")
    return {1}


def _leaving(dogs):
    dogs[2].mark_leaving()
    dogs[2].stop()
    return {2}


@pytest.mark.parametrize("scenario,world,g,want", [
    (_silent, 3, None, "no liveness beat"),
    (_poisoned, 3, None, "poison record: engine"),
    (_leaving, 3, None, "left the world"),
    (_silent, 4, 2, "no liveness beat"),
], ids=["silent", "poison", "leaving", "leader-of-group"])
def test_watchdog_decisions_equal_jax(scenario, world, g, want):
    """A silent peer, a poison record, an announced departure, and (with
    leader groups of 2) a dead leader: every other rank decides once,
    naming the same rank for the same reason, in both packages."""
    got = _watch(thealth, TGroupLayout, world, scenario, g)
    ref = _watch(jhealth, JGroupLayout, world, scenario, g)
    assert got == ref
    dead = sorted(set(range(world)) - set(got))[0]
    assert all(c == [(dead, want)] for c in got.values()), got


def test_watchdog_views():
    kv = _DictKV()
    dogs = [thealth.HealthWatchdog(kv, 2, r, "h", on_failure=print,
                                   interval_s=0.05, timeout_s=5.0,
                                   global_ranks=[3, 7])
            for r in range(2)]
    assert dogs[0].describe_peers() == "no peers tracked"
    for d in dogs:
        d.start()
    try:
        time.sleep(0.3)
        assert re.fullmatch(r"rank 7: beat \d+\.\ds ago",
                            dogs[0].describe_peers())
        stats = thealth.health_stats()
        mine = [w for w in stats["watchdogs"] if w["rank"] == 3]
        assert mine and mine[0]["member_ranks"] == [3, 7]
        assert mine[0]["beats_sent"] >= 2 and mine[0]["failed_peer"] is None
        assert set(stats) == {"retries", "faults", "watchdogs"}
    finally:
        for d in dogs:
            d.stop()
    assert not [w for w in thealth.health_stats()["watchdogs"]
                if w["rank"] == 3]


LAG_ROUNDS = [{0: 0.0, 1: 0.2, 2: 1.5}, {0: 0.0, 1: 1.2, 2: 2.0},
              {0: 0.0, 1: 0.1, 2: 3.0}, {0: 0.0, 2: 2.5}, {0: 0.5, 1: 0.0},
              {}, {0: 0.0, 1: 4.0}, {0: 0.0, 1: 4.0}, {0: 0.0, 1: 4.0}]


def test_straggler_tracker_equals_jax(clean_metrics):
    """The same lags name the same stragglers, streaks and warnings."""
    stats = []
    for health in (thealth, jhealth):
        tr = health.StragglerTracker(0, [10, 11, 12], threshold_s=1.0,
                                     sustain_rounds=3, warn_interval_s=0.0)
        for lags in LAG_ROUNDS:
            tr.observe(lags, ["t1", "t0"])
        stats.append(tr.stats())
    assert stats[0] == stats[1]
    assert stats[0]["straggler_rounds"] == {11: 3, 12: 4}
    assert stats[0]["warnings"] == 3
    assert tmetrics.STRAGGLER_ROUNDS.value({"rank": 12}) == 4


# --------------------------------------------------------------------------
# (h) the timeline
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def timeline_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("timeline")
    env = {"HVD_TIMELINE": str(tmp / "tl.json"),
           "HVD_TIMELINE_MARK_CYCLES": "1", "HVD_PENDING_CYCLE_TIME": "10"}
    ranks = run_world("_timeline_rank", tmp, size=2,
                      module="test_torch_negotiation", env=env, kv=True,
                      timeout_s=90)
    return tmp, ranks


def _lanes(events) -> dict:
    lanes: dict = {}
    for e in events:
        if e["ph"] in ("B", "E"):
            lanes.setdefault(e["cat"], []).append((e["name"], e["ph"]))
    return lanes


def test_timeline_files_hold_every_named_tensor(timeline_world):
    """Each rank's ``<HVD_TIMELINE>.<rank>`` is Chrome-trace JSON with a
    NEGOTIATE range (on the request's lane, ``<name>.<i>``) and an op
    range (on the op's lane) for every named collective, each begun and
    ended, and a CYCLE instant per negotiation cycle."""
    tmp, ranks = timeline_world
    for r, res in enumerate(ranks):
        assert bool(res["active"])
        events = json.loads((tmp / f"tl.json.{r}").read_text())
        lanes = _lanes(events)
        for name in TIMELINE_NAMES:
            assert lanes[f"{name}.0"] == [("NEGOTIATE", "B"),
                                          ("NEGOTIATE", "E")]
            assert lanes[name] == [("ALLREDUCE", "B"), ("ALLREDUCE", "E")]
        assert lanes["grp"] == [("GROUPED_ALLREDUCE", "B"),
                                ("GROUPED_ALLREDUCE", "E")]
        assert lanes["grp.0"] == lanes["grp.1"] == lanes["bc.0"] == [
            ("NEGOTIATE", "B"), ("NEGOTIATE", "E")]
        assert lanes["bc"] == [("BROADCAST", "B"), ("BROADCAST", "E")]
        names = {e["args"]["name"] for e in events if e["ph"] == "M"}
        assert set(lanes) <= names
        assert any(e["name"] == "CYCLE" and e["ph"] == "i" for e in events)
        ts = [e["ts"] for e in events if "ts" in e]
        assert ts == sorted(ts)


def test_merged_timeline_equals_jax(timeline_world, tmp_path):
    """``merge_timelines`` of both packages on the same files writes the
    same trace: one pid a rank, a ``process_name`` each, time-sorted."""
    tmp, _ = timeline_world
    inputs = [str(tmp / f"tl.json.{r}") for r in range(2)]
    n_t = ttimeline.merge_timelines(inputs, str(tmp_path / "t.json"))
    n_j = jtimeline.merge_timelines(inputs, str(tmp_path / "j.json"))
    merged = json.loads((tmp_path / "t.json").read_text())
    assert n_t == n_j == len(merged)
    assert merged == json.loads((tmp_path / "j.json").read_text())
    assert {e["pid"] for e in merged} == {0, 1}
    assert [e["args"]["name"] for e in merged
            if e["name"] == "process_name"] == ["rank 0", "rank 1"]
    res = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.timeline",
                          str(tmp_path / "cli.json"), *inputs], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert json.loads((tmp_path / "cli.json").read_text()) == merged


def test_timeline_results_are_the_sums(timeline_world):
    _, ranks = timeline_world
    for res in ranks:
        for i, name in enumerate(TIMELINE_NAMES):
            np.testing.assert_array_equal(res[name],
                                          np.full(3, 1.0 + 2 * i))


def test_merge_tolerates_an_unclosed_file(tmp_path):
    (tmp_path / "a.3").write_text('[\n{"name": "X", "ph": "i", "ts": 5},\n')
    (tmp_path / "b").write_text('[{"name": "Y", "ph": "i", "ts": 1}]')
    out = tmp_path / "m.json"
    for mod in (ttimeline, jtimeline):
        assert mod.merge_timelines([str(tmp_path / "a.3"),
                                    str(tmp_path / "b")], str(out)) == 4
    merged = json.loads(out.read_text())
    assert [(e["name"], e["pid"]) for e in merged] == [
        ("process_name", 3), ("process_name", 1), ("Y", 1), ("X", 3)]


def test_op_range_records_only_while_active(tmp_path):
    path = tmp_path / "t.json"
    with ttimeline.op_range("x", "ALLREDUCE"):
        pass  # inactive: nothing, no error
    ttimeline.start_timeline(str(path))
    try:
        with ttimeline.op_range("loss", "ALLREDUCE"):
            ttimeline.record_retry("kv.put", 2)
            ttimeline.record_health_event("PEER_DEAD.1")
        ttimeline.mark_cycle()  # cycles not marked: nothing
    finally:
        ttimeline.stop_timeline()
    with ttimeline.op_range("late", "ALLREDUCE"):
        pass
    events = json.loads(path.read_text())
    assert [(e["name"], e["ph"]) for e in events if e["ph"] != "M"] == [
        ("ALLREDUCE", "B"), ("RETRY.kv.put.2", "i"), ("PEER_DEAD.1", "i"),
        ("ALLREDUCE", "E")]
    ttimeline.start_timeline(str(tmp_path / "again.json"), mark_cycles=True)
    try:
        ttimeline.mark_cycle()
    finally:
        ttimeline.stop_timeline()
    again = json.loads((tmp_path / "again.json").read_text())
    assert [e["args"]["name"] for e in again if e["ph"] == "M"] == [
        "negotiation"]


@pytest.mark.parametrize("value,size,want", [
    ("t.json", 1, "t.json"), ("t.json", 4, "t.json.2"), ("DYNAMIC", 4, None),
    (None, 4, None)])
def test_autostart_names_the_file_as_jax(monkeypatch, tmp_path, value,
                                         size, want):
    monkeypatch.chdir(tmp_path)
    if value is None:
        monkeypatch.delenv("HVD_TIMELINE", raising=False)
    else:
        monkeypatch.setenv("HVD_TIMELINE", value)
    ttimeline.maybe_autostart(2, size)
    try:
        assert ttimeline.timeline_active() == (want is not None)
    finally:
        ttimeline.stop_timeline()
    assert sorted(p.name for p in tmp_path.iterdir()) == (
        [want] if want else [])


def test_autostart_failure_is_logged_not_raised(monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TIMELINE", str(tmp_path / "no" / "dir" / "t"))
    ttimeline.maybe_autostart(0, 1)
    assert not ttimeline.timeline_active()
