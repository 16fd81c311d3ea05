"""The port's negotiation control plane against the JAX package's: leader
groups, the hierarchical exchange, the coordinator ResponseCache, the
service's cache decisions, and the health watchdog.

Every comparison is of bytes, decisions or counters, so every one is
exact:

* (a) ``GroupLayout`` of both packages for worlds 1-64 and groups 1-9;
* (b) both packages' ``HierarchicalTransport`` over one dict-backed KV
  store on the same frames: the same ``(datas, bitvs)`` and the same keys
  and blobs written; the port's two-level round equals its flat one;
* (c) one event sequence through both packages' ``ResponseCache``: the
  same lookups and counters;
* (d) in-process services of both packages over a lockstep in-memory
  world whose cycles the test releases one at a time (so every rank's
  submission lands in the same cycle), ``HVD_RESPONSE_CACHE=1``, worlds of
  2, 4 and 16: the same served-or-negotiated decision for every call, the
  same responses and the same ``response_cache_stats()``;
* (e, f) a spawned gloo world of 4 (flat, then hierarchical at
  ``HVD_NEGOTIATION_GROUP_SIZE=2``) whose rank 2's rounds are slowed by
  ``HVD_FAULT_SPEC``: served collectives interleaved with uncached
  allgathers, results equal to the JAX package's, conformance traces that
  ``python -m tools.hvdtrace`` diffs clean;
* (g) the watchdog: rank 1 of 4 killed by ``HVD_FAULT_SPEC`` at its sixth
  negotiated call; the others raise ``PeerFailureError`` naming it within
  ``HVD_HEALTH_TIMEOUT`` + 5 s.

The rank side is ``test_torch_negotiation.py`` (no JAX).
"""

import dataclasses
import json
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest

from horovod_tpu import dynamic as jdyn
from horovod_tpu import engine_service as jsvc
from horovod_tpu.negotiation import GroupLayout as JGroupLayout
from horovod_tpu.negotiation import HierarchicalTransport as JHier
from horovod_tpu.negotiation import ResponseCache as JCache
from horovod_tpu.utils import envs as jenvs

from horovod_tpu_torch import dynamic as tdyn
from horovod_tpu_torch import engine_service as tsvc
from horovod_tpu_torch.negotiation import GroupLayout as TGroupLayout
from horovod_tpu_torch.negotiation import HierarchicalTransport as THier
from horovod_tpu_torch.negotiation import ResponseCache as TCache
from horovod_tpu_torch.utils import envs as tenvs
from test_torch_negotiation import (CACHE_ITERS, CACHE_ROOT, WATCHDOG_CALLS,
                                    cache_inputs)
from test_torch_world2 import REPO, run_world


# --------------------------------------------------------------------------
# (a) leader groups
# --------------------------------------------------------------------------

def _layout_view(layout_cls, world: int, g: int):
    lay = layout_cls(world, g)
    return (lay.n_groups, lay.leaders(), repr(lay),
            [list(lay.members_of(i)) for i in range(lay.n_groups)],
            [lay.leader_of(i) for i in range(lay.n_groups)],
            [(lay.group_of(r), lay.is_leader(r)) for r in range(world)])


@pytest.mark.parametrize("g", range(1, 10))
def test_group_layout_equals_jax(g):
    for world in range(1, 65):
        assert (_layout_view(TGroupLayout, world, g)
                == _layout_view(JGroupLayout, world, g)), (world, g)


@pytest.mark.parametrize("args", [(0, 2), (4, 0), (-1, 1)])
def test_group_layout_refuses_what_jax_refuses(args):
    with pytest.raises(ValueError) as t:
        TGroupLayout(*args)
    with pytest.raises(ValueError) as j:
        JGroupLayout(*args)
    assert str(t.value) == str(j.value)


def test_group_layout_range_checks_equal_jax():
    for cls in (TGroupLayout, JGroupLayout):
        lay = cls(5, 2)
        for bad in (lambda: lay.group_of(5), lambda: lay.members_of(3),
                    lambda: lay.is_leader(-1), lambda: lay.leader_of(3)):
            with pytest.raises(ValueError):
                bad()


# --------------------------------------------------------------------------
# (b) the two-level exchange over one dict-backed KV store
# --------------------------------------------------------------------------

class _DictKV:
    """A thread-safe in-memory KV store with the ``KVClient`` surface;
    each key's receipt time is a function of the key, so the leaders'
    packed blobs are the same from run to run."""

    def __init__(self):
        self.cond = threading.Condition()
        self.store: dict = {}
        self.puts: list = []

    def put(self, key, value):
        with self.cond:
            self.store[key] = bytes(value)
            self.puts.append((key, bytes(value)))
            self.cond.notify_all()

    def get(self, key):
        with self.cond:
            return self.store.get(key)

    def keys(self, scope=""):
        prefix = scope.rstrip("/") + "/"
        with self.cond:
            return sorted(k for k in self.store if k.startswith(prefix))

    def delete(self, key):
        with self.cond:
            for k in [k for k in self.store
                      if k == key or k.startswith(key.rstrip("/") + "/")]:
                del self.store[k]

    def gather(self, scope, count, timeout=60.0, with_times=False):
        prefix = scope.rstrip("/") + "/"
        with self.cond:
            if not self.cond.wait_for(
                    lambda: sum(k.startswith(prefix)
                                for k in self.store) >= count,
                    timeout=min(timeout, 30.0)):
                raise TimeoutError(scope)
            got = {k: v for k, v in sorted(self.store.items())
                   if k.startswith(prefix)}
        times = {k: float(zlib.crc32(k.encode()) % 997) / 8 for k in got}
        return (got, times) if with_times else got


def _frame(rank: int, cycle: int) -> tuple[bytes, bytes]:
    rng = np.random.default_rng(100 * cycle + rank)
    req = rng.integers(0, 256, 5 + rank).astype(np.uint8).tobytes()
    return req, bytes([rank & 0xFF, cycle & 0xFF])


def _run_exchange(make, n: int, cycles: int = 3):
    """Every member's ``(datas, bitvs)`` of each cycle, and the KV store's
    writes and final keys."""
    kv = _DictKV()
    transports = [make(kv, n, r) for r in range(n)]
    out = [[None] * cycles for _ in range(n)]
    errors = []

    def member(r):
        try:
            for c in range(cycles):
                out[r][c] = transports[r].exchange(c, *_frame(r, c), 30.0)
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=member, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out, sorted(kv.puts), sorted(kv.store), transports


@pytest.mark.parametrize("n,g", [(n, g) for n in range(2, 6)
                                 for g in range(1, 4)])
def test_hierarchical_exchange_equals_jax_and_flat(n, g):
    """The same frames through both packages' two-level round give the
    same tables, the same KV writes (keys and packed blobs) and the same
    keys left; the port's two-level tables are its flat round's."""
    tout, tputs, tkeys, tts = _run_exchange(
        lambda kv, n, r: THier(kv, n, r, prefix="p", group_size=g), n)
    jout, jputs, jkeys, jts = _run_exchange(
        lambda kv, n, r: JHier(kv, n, r, prefix="p", group_size=g), n)
    flat, _, _, _ = _run_exchange(
        lambda kv, n, r: tsvc.KVTransport(kv, n, r, prefix="p"), n)
    assert tout == jout
    assert tputs == jputs
    assert tkeys == jkeys
    assert tout == flat
    for t, j in zip(tts, jts):
        assert t.last_lags == j.last_lags
        assert (t.group_layout.n_groups, t.group_layout.leaders()) == (
            j.group_layout.n_groups, j.group_layout.leaders())


# --------------------------------------------------------------------------
# (c) one event sequence through both ResponseCaches
# --------------------------------------------------------------------------

def _req(name, rtype=0, shape=(4,), **kw):
    return dict(name=name, request_type=rtype, shape=shape, **kw)


def _resp(dyn, names, from_cache=False, **kw):
    return dyn.Response(type=kw.pop("type", 0), tensor_names=list(names),
                        from_cache=from_cache, **kw)


def _cache_events(cache_cls, dyn) -> list:
    """Drive one cache through insert, confirm, a signature mismatch,
    uncacheable types, a fused response, LRU eviction, invalidation,
    ``drop_name`` and the warm machinery; returns every observation."""
    seen = []
    lookup = lambda c, req: (  # noqa: E731
        None if c.lookup_confirmed(req) is None
        else dataclasses.asdict(c.lookup_confirmed(req)))
    c = cache_cls(3, "global")
    a, b = _req("a"), _req("b", dtype=2)
    c.note_response(a, _resp(dyn, ["a"]))
    seen.append(("fresh", lookup(c, a), c.stats()))
    c.note_response(a, _resp(dyn, ["a"], from_cache=True))
    seen.append(("confirmed", lookup(c, a), c.stats()))
    seen.append(("other shape", lookup(c, _req("a", shape=(5,)))))
    seen.append(("other op", lookup(c, _req("a", reduce_op=1))))
    seen.append(("other scale", lookup(c, _req("a", prescale=2.0))))
    for req in (_req("ag", 1), _req("bar", 6), _req("j", 3),
                _req("a2av", 5, splits=(1, 2))):
        c.note_response(req, _resp(dyn, [req["name"]], from_cache=True))
        seen.append(("uncacheable", req["name"], lookup(c, req)))
    c.note_response(b, _resp(dyn, ["b", "b2"], from_cache=True))
    seen.append(("fused", lookup(c, b), len(c)))
    c.note_response(b, _resp(dyn, ["b"], from_cache=True))
    c.note_response(_req("err"), _resp(dyn, ["err"], type=8,
                                       error_message="x"))
    for name in ("c", "d", "e"):  # LRU: a and b leave
        c.note_response(_req(name), _resp(dyn, [name], from_cache=True))
    seen.append(("lru", [lookup(c, _req(x)) is not None
                         for x in "abcde"], c.stats()))
    c.note_response(_req("c", shape=(9,)), _resp(dyn, ["c"]))
    seen.append(("replaced", lookup(c, _req("c")),
                 lookup(c, _req("c", shape=(9,))), c.confirmed_count()))
    c.count_served(2)
    c.count_missed(3)
    c.count_missed(0)
    shelf = c.export_entries()
    seen.append(("export", [(n, s, dataclasses.asdict(r))
                            for n, s, r in shelf]))
    c.drop_name("d")
    seen.append(("drop", len(c), c.stats()))
    seen.append(("invalidate", c.invalidate("test"), c.invalidate("again"),
                 c.stats()))
    w = cache_cls(2, "ps1")
    seen.append(("empty digest", w.warm_digest(), w.warm_count()))
    seen.append(("restore", w.restore_warm(shelf), w.warm_count(),
                 w.warm_digest(), lookup(w, _req("e"))))
    seen.append(("confirm warm", w.confirm_warm(), lookup(w, _req("e")),
                 w.stats()))
    w2 = cache_cls(4, "ps1")
    w2.restore_warm(shelf)
    seen.append(("drop warm", w2.drop_warm(), w2.stats()))
    off = cache_cls(0, "global")
    off.note_response(a, _resp(dyn, ["a"], from_cache=True))
    seen.append(("off", lookup(off, a), off.stats()))
    return seen


def test_response_cache_decisions_equal_jax():
    assert _cache_events(TCache, tdyn) == _cache_events(JCache, jdyn)


def test_response_cache_helpers_equal_jax():
    from horovod_tpu.negotiation import response_cache as jrc
    from horovod_tpu_torch.negotiation import response_cache as trc
    reqs = [_req("a"), _req("g", 1), _req("b", 6), _req("j", 3),
            _req("v", 5, splits=(2, 1)), _req("v", 5, splits=()),
            _req("s", 2, root_rank=1, group_id=7, splits_crc=3)]
    assert ([trc.cacheable(r) for r in reqs]
            == [jrc.cacheable(r) for r in reqs])
    assert ([trc.signature(r) for r in reqs]
            == [jrc.signature(r) for r in reqs])
    trc.clear_shelf()
    for world in (2, 4, 8):
        for rank in range(world):
            trc.shelve(("proc", "0", world, rank), [("x", (), None)])
    assert trc.take_shelved(("proc", "0", 8, 7)) == [("x", (), None)]
    assert trc.take_shelved(("proc", "0", 8, 7)) is None
    trc.shelve(("proc", "0", 2, 0), [])  # nothing to park
    trc.clear_shelf()
    assert trc.take_shelved(("proc", "0", 4, 0)) is None


@pytest.mark.parametrize("raw", [None, "auto", "0", "1", "64", "junk", "-3"])
@pytest.mark.parametrize("hier", [None, "auto", "1", "0"])
def test_cache_and_hierarchy_knobs_equal_jax(monkeypatch, raw, hier):
    for name, val in (("HVD_RESPONSE_CACHE", raw),
                      ("HVD_HIER_NEGOTIATION", hier)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    for world in (None, 1, 2, 8, 9, 64):
        assert (tenvs.response_cache_capacity(world)
                == jenvs.response_cache_capacity(world)), world
        if world is not None:
            assert (tenvs.hier_negotiation_enabled(world)
                    == jenvs.hier_negotiation_enabled(world)), world
    monkeypatch.setenv("HVD_NEGOTIATION_GROUP_SIZE", "0")
    assert tenvs.negotiation_group_size() == jenvs.negotiation_group_size()


def test_override_epoch_moves_as_jax():
    """The override table both caches key their epoch rule on."""
    seen = []
    for e in (tenvs, jenvs):
        e0 = e.override_epoch()
        e.set_override("CYCLE_TIME", "33")
        e.set_override("CYCLE_TIME", "33")  # the same value: no move
        got = e.get("CYCLE_TIME")
        e.clear_override("CYCLE_TIME")
        e.clear_override("CYCLE_TIME")
        e.set_override("FUSION_THRESHOLD", 5)
        e.clear_overrides()
        e.clear_overrides()
        seen.append((e.override_epoch() - e0, got, e.get("CYCLE_TIME")))
    assert seen[0] == seen[1] == (4, "33", None)


# --------------------------------------------------------------------------
# (d) both packages' services over a lockstep world of released cycles
# --------------------------------------------------------------------------

class _GatedWorld:
    """An in-memory lockstep exchange whose cycles the test releases one
    at a time: while every member is parked at the gate, a submission on
    each lands in the same cycle on every member, as its cycle thread has
    already taken the parked cycle's requests."""

    def __init__(self, n):
        self.n = n
        self.cond = threading.Condition()
        self.frames: dict = {}
        self.parked: dict = {}
        self.allowed = 0
        self.closed = False

    def exchange(self, rank, cycle, req, bits):
        end = time.monotonic() + 60.0
        with self.cond:
            self.parked[rank] = cycle
            self.cond.notify_all()
            while cycle >= self.allowed:
                self._wait(end)
            fr = self.frames.setdefault(cycle, {})
            fr[rank] = (req, bits)
            self.cond.notify_all()
            while len(fr) < self.n:
                self._wait(end)
            self.frames.pop(cycle - 2, None)
            return ([fr[r][0] for r in range(self.n)],
                    [fr[r][1] for r in range(self.n)])

    def _wait(self, end):
        if self.closed:
            raise RuntimeError("world closed")
        if time.monotonic() > end:
            raise TimeoutError("gated world: a cycle did not complete")
        self.cond.wait(0.05)

    def wait_parked(self):
        with self.cond:
            assert self.cond.wait_for(
                lambda: len(self.parked) == self.n and all(
                    c == self.allowed for c in self.parked.values()),
                timeout=30), (self.parked, self.allowed)

    def release(self, wait: bool = True):
        with self.cond:
            self.allowed += 1
            self.cond.notify_all()
        if wait:
            self.wait_parked()

    def close(self):
        with self.cond:
            self.closed = True
            self.cond.notify_all()


class _GatedTransport:
    def __init__(self, world, rank):
        self.world_mem = world
        self.world_size = world.n
        self.rank = rank

    def exchange(self, cycle, req, bits, timeout):
        return self.world_mem.exchange(self.rank, cycle, req, bits)


@pytest.fixture
def cache_on(monkeypatch):
    monkeypatch.setenv("HVD_RESPONSE_CACHE", "1")
    monkeypatch.setenv("HVD_STALL_CHECK_DISABLE", "1")


class _World:
    """One package's n services over a gated world."""

    def __init__(self, pkg, n, capacities=None):
        self.dyn, self.svc_mod, self.envs = pkg
        self.world = _GatedWorld(n)
        self.svcs = [self.svc_mod.DynamicService(
            self.dyn.NativeEngine(
                world_size=n, rank=r,
                cache_capacity=capacities[r] if capacities else None),
            _GatedTransport(self.world, r)) for r in range(n)]
        self.world.wait_parked()

    def call(self, reqs) -> tuple:
        """Every rank submits ``reqs`` (a list of request dicts) at one
        gate; cycles are released until every plan has arrived. Returns
        the decisions (served per rank) and responses of rank 0 with every
        rank's equal to it."""
        self.world.wait_parked()
        tickets = [s.negotiate_many_submit([dict(q) for q in reqs])
                   for s in self.svcs]
        for _ in range(20):
            if all(p.event.is_set() for t in tickets for p in t.pends):
                break
            self.world.release()
        resps = [s.negotiate_many_wait(t, timeout=30)
                 for s, t in zip(self.svcs, tickets)]
        views = [[dataclasses.asdict(x) for x in rs] for rs in resps]
        assert all(v == views[0] for v in views)
        return tuple(t.served for t in tickets), views[0]

    def join_all(self) -> list:
        """Every rank joins at one gate (a thread each); returns what each
        join returned or raised."""
        self.world.wait_parked()
        out = [None] * len(self.svcs)

        def one(i, s):
            try:
                out[i] = s.join(f"join{i}", timeout=30)
            except Exception as e:  # the error is the observation
                out[i] = f"{type(e).__name__}: {e}"

        threads = [threading.Thread(target=one, args=(i, s), daemon=True)
                   for i, s in enumerate(self.svcs)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while not all(any(k.startswith("join") for k in s._pending)
                      for s in self.svcs):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        while any(t.is_alive() for t in threads):
            assert time.monotonic() < deadline
            self.world.release()
        return out

    def stats(self):
        return [s.response_cache_stats() for s in self.svcs]

    def close(self):
        self.world.close()
        for s in self.svcs:
            s.stop()


_PKGS = {"jax": (jdyn, jsvc, jenvs), "port": (tdyn, tsvc, tenvs)}


def _sequence(pkg, n) -> list:
    """The named call sequence of (d); returns every observation."""
    w = _World(pkg, n)
    seen = []
    try:
        g4, g9 = [_req("g")], [_req("g", shape=(9,))]
        for _ in range(4):  # fresh, confirmed, served, served
            seen.append(("g", w.call(g4)))
        for _ in range(4):  # changed metadata: a real round, then again
            seen.append(("g9", w.call(g9)))
        for i in range(2):  # never cached
            seen.append(("ag", w.call([_req(f"ag{i}", 1, shape=(i + 1,))])))
        seen.append(("bar", w.call([_req("bar", 6, shape=())])))
        pair = [_req("p.0", group_id=5), _req("p.1", group_id=5)]
        for _ in range(3):  # fused into one response: never served
            seen.append(("pair", w.call(pair)))
        w.envs.set_override("CYCLE_TIME", "33")
        try:
            seen.append(("epoch", w.call(g9), w.stats()))
        finally:
            w.envs.clear_override("CYCLE_TIME")
        for _ in range(3):
            seen.append(("after epoch", w.call(g9)))
        seen.append(("stats", w.stats()))
        w.world.release()  # an idle cycle: no serve in the join's window
        seen.append(("join", w.join_all()))
        for _ in range(2):  # latched: real rounds for good
            seen.append(("latched", w.call(g9)))
        seen.append(("final", w.stats()))
    finally:
        w.close()
    return seen


@pytest.mark.parametrize("n", [2, 4, 16])
def test_service_cache_decisions_equal_jax(cache_on, n):
    port, ref = _sequence(_PKGS["port"], n), _sequence(_PKGS["jax"], n)
    assert port == ref
    decisions = [o[1][0] for o in port if o[0] in ("g", "latched")]
    assert decisions == [(served,) * n for served in
                         (False, False, True, True, False, False)]


@pytest.mark.parametrize("n", [2, 4])
def test_bit_vector_divergence_equals_jax(cache_on, n):
    """A rank whose native cache holds nothing breaks the AND every
    cycle: no entry is ever confirmed, every call takes a real round."""
    def run(pkg):
        w = _World(pkg, n, capacities=[1024] + [0] * (n - 1))
        try:
            return [w.call([_req("d")]) for _ in range(5)], w.stats()
        finally:
            w.close()
    port, ref = run(_PKGS["port"]), run(_PKGS["jax"])
    assert port == ref
    assert not any(any(served) for served, _ in port[0])
    assert all(s["hits"] == 0 and s["misses"] == 5 for s in port[1])


@pytest.mark.parametrize("n", [2, 4])
def test_join_racing_a_serve_fails_as_jax(cache_on, n):
    """Rank 0's JOIN is on its way (taken into the next cycle) when the
    others serve a batch: they see the JOIN in a cycle whose window holds
    a serve that the joined rank can never pair, and fail at once with
    ``ResponseCacheJoinError`` naming rank 0."""
    def run(pkg):
        w = _World(pkg, n)
        joined, out = w.svcs[0], {}

        def join():
            try:
                out["join"] = joined.join("j", timeout=30)
            except Exception as e:  # the error is the observation
                out["join"] = type(e).__name__

        t = threading.Thread(target=join, daemon=True)
        try:
            decisions = [w.call([_req("r")])[0] for _ in range(2)]
            t.start()
            deadline = time.monotonic() + 30
            while "j" not in joined._pending:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            w.world.release()  # rank 0's cycle thread takes the JOIN
            decisions.append(tuple(
                s.negotiate_many_submit([_req("r")]).served
                for s in w.svcs[1:]))
            w.world.release(wait=False)  # the cycle that carries it
            while not all(s._failure for s in w.svcs[1:]):
                assert time.monotonic() < deadline
                time.sleep(0.005)
            errors = [f"{type(s._failure_exc).__name__}: {s._failure_exc}"
                      for s in w.svcs[1:]]
            return decisions, errors, w.stats()
        finally:
            w.close()
            t.join(30)
    port, ref = run(_PKGS["port"]), run(_PKGS["jax"])
    assert port == ref
    assert port[0][-1] == (True,) * (n - 1)
    assert all(e.startswith("ResponseCacheJoinError: coordinator "
                            "ResponseCache served 1 batch(es) locally "
                            "while rank 0's JOIN") for e in port[1])


def test_served_ticket_leaves_pending_untouched(cache_on):
    """A name still negotiated raises ``DuplicateNameError`` even where
    the cache could serve it, and the registration survives."""
    w = _World(_PKGS["port"], 2)
    try:
        for _ in range(3):
            w.call([_req("dup")])
        svc = w.svcs[0]
        fake = tsvc._Pending()
        with svc._mu:
            svc._pending["dup"] = fake
        with pytest.raises(tdyn.DuplicateNameError):
            svc.negotiate_many_submit([_req("dup")])
        assert svc._pending["dup"] is fake
        with svc._mu:
            svc._pending.pop("dup")
    finally:
        w.close()
    assert all(s["entries"] == 0 and s["invalidations"] == 1
               for s in w.stats())  # stop drops the cache


# --------------------------------------------------------------------------
# the served collectives' place in the issue order, in one process
# --------------------------------------------------------------------------

def test_run_until_issues_served_by_submission_order():
    """Queue: A, S1 (served), B, C, S2 (served); B's plan arrives first,
    then A's, then C's. The issue order is A, S1, B, C, S2: a served
    collective waits for everything submitted before it, and what is
    submitted after it waits for it, whatever order the plans come in."""
    svc = tsvc.DynamicService.__new__(tsvc.DynamicService)
    svc._issue_lock = threading.RLock()
    svc._mu = threading.Lock()
    svc._pending, svc._queue, svc._rcache = {}, [], None
    issued, pends, items = [], {}, {}
    for key in ("A", "S1", "B", "C", "S2"):
        pend = tsvc._Pending()
        pend.response = tdyn.Response(type=0, tensor_names=[key])
        served = key.startswith("S")
        if served:
            pend.event.set()
        pends[key] = pend
        items[key] = tsvc.Queued(
            tsvc.NegotiationTicket([{"name": key}], [pend], served=served),
            lambda _r, key=key: issued.append(key))
        svc._queue.append(items[key])

    def arrives(key, order):
        pends[key].order = order
        pends[key].event.set()

    arrives("B", 0)
    svc.run_until(block=False)  # A has no plan: nothing may issue
    svc.run_until(items["S1"], block=False)
    assert issued == []
    arrives("A", 1)
    svc.run_until(items["B"], block=False)
    assert issued == ["A", "S1", "B"]
    arrives("C", 2)
    svc.run_until(items["S2"])
    assert issued == ["A", "S1", "B", "C", "S2"] and not svc._queue


# --------------------------------------------------------------------------
# (e, f) served traffic at a gloo world of 4; (g) the watchdog
# --------------------------------------------------------------------------

WORLD_TIMEOUT_S = 90  # each spawned world below finishes in ~10 s
# a 10 ms busy cycle, as test_torch_negotiation's worlds: their KV traffic
# stays off the cores of the timing-sensitive tests xdist runs beside them
PACED = {"HVD_PENDING_CYCLE_TIME": "10"}


@pytest.fixture(scope="module", params=[None, "2"], ids=["flat", "g2"])
def cache_world(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"cache_{request.param or 'flat'}")
    env = {**PACED, "HVD_RESPONSE_CACHE": "1",
           "HVD_FAULT_SPEC": "svc.exchange:delay=0.05:rank=2",
           "HVD_CONFORMANCE": "1",
           "HVD_CONFORMANCE_DIR": str(tmp / "traces")}
    if request.param:
        env["HVD_NEGOTIATION_GROUP_SIZE"] = request.param
    ranks = run_world("_cache_rank", tmp, size=4,
                      module="test_torch_negotiation", env=env, kv=True,
                      timeout_s=WORLD_TIMEOUT_S)
    return request.param, tmp, ranks


@pytest.fixture
def pset4(hvd):
    ps = hvd.add_process_set([0, 1, 2, 3])
    yield ps
    hvd.remove_process_set(ps)


def _bundle(hvd, ps, arrays):
    return hvd.per_rank([np.asarray(a) for a in arrays], ps)


def test_served_traffic_results_equal_jax(hvd, cache_world, pset4):
    """Served allreduces and broadcasts, waited for in another order on
    each rank, interleaved with negotiated allgathers while rank 2's
    rounds lag: every result is the JAX package's, bitwise."""
    _, _, ranks = cache_world
    for it in range(CACHE_ITERS):
        x = cache_inputs(4, it)
        want = {
            "a": hvd.allreduce(_bundle(hvd, pset4, x["a"]), op=hvd.Sum,
                               process_set=pset4),
            "g": hvd.allgather(_bundle(hvd, pset4, x["g"]),
                               process_set=pset4),
            "b": hvd.broadcast(_bundle(hvd, pset4, x["b"]), CACHE_ROOT,
                               process_set=pset4),
            "c": hvd.allreduce(_bundle(hvd, pset4, x["c"]),
                               op=hvd.Average, process_set=pset4)}
        for res in ranks:
            for k, v in want.items():
                v = np.asarray(v)
                got = res[f"{k}{it}"]
                assert got.dtype == v.dtype and got.shape == v.shape, k
                np.testing.assert_array_equal(got, v)


def test_served_traffic_takes_no_round(cache_world):
    """Two iterations confirm the three cacheable names; from then on
    every one is served and only the allgather takes a round (or two,
    where the ranks' requests land in consecutive cycles)."""
    g, _, ranks = cache_world
    for res in ranks:
        assert res["served"].tolist() == [0, 0] + [3] * (CACHE_ITERS - 2)
        assert all(1 <= x <= 3 for x in res["rounds"].tolist()[2:])
        stats = json.loads(str(res["stats"]))["global"]
        assert (stats["hits"], stats["misses"], stats["confirmed"]) == (
            3 * (CACHE_ITERS - 2), 6, 3)
        assert str(res["transport"]) == ("HierarchicalTransport" if g
                                         else "KVTransport")


def test_served_traffic_traces_diff_clean(cache_world):
    """Every rank's conformance trace (service start and stop, the
    confirm and serve flips) passes ``tools.hvdtrace``: no divergence."""
    _, tmp, _ = cache_world
    traces = sorted((tmp / "traces").glob("hvdtrace-*.json"))
    assert len(traces) == 4
    res = subprocess.run([sys.executable, "-m", "tools.hvdtrace", "--json",
                          str(tmp / "traces")], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    report = json.loads(res.stdout)
    assert report["clean"] and report["summary"]["traces"] == 4
    doc = json.loads(traces[0].read_text())
    kinds = [e[4] for e in doc["events"]]
    assert kinds.count("confirm") == 3
    assert kinds.count("served") == 3 * (CACHE_ITERS - 2)
    assert kinds[0] == "svc_start" and kinds[-1] == "svc_stop"


def test_watchdog_names_a_dead_rank(tmp_path):
    """Rank 1 exits at its sixth negotiated call; the other three raise
    ``PeerFailureError`` naming it within ``HVD_HEALTH_TIMEOUT`` + 5 s,
    not after the 600 s exchange deadline."""
    timeout_s = 3.0
    env = {**PACED, "HVD_FAULT_SPEC": "svc.submit:crash:rank=1:after=5",
           "HVD_HEALTH_INTERVAL": "0.5",
           "HVD_HEALTH_TIMEOUT": str(timeout_s)}
    ranks = run_world("_watchdog_rank", tmp_path, size=4,
                      module="test_torch_negotiation", env=env, kv=True,
                      timeout_s=WORLD_TIMEOUT_S, exit_codes={1: 1})
    assert ranks[1] is None
    assert WATCHDOG_CALLS > 6
    for r in (0, 2, 3):
        res = ranks[r]
        assert int(res["failed_at"]) == 5
        assert int(res["dead_rank"]) == 1
        assert float(res["seconds"]) < timeout_s + 5.0
        assert "peer rank 1 failed" in str(res["error"])
