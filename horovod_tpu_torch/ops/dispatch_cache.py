"""Steady-state dispatch plan cache for eager collectives (port of
``horovod_tpu/ops/dispatch_cache.py``).

The Python twin of the reference's ResponseCache fast path
(``response_cache.h:107-169``): a :class:`DispatchPlan` holds every
decision the first call of a signature resolved, so later calls with the
same key go straight from the user's tensors to the wire. In the port a
plan holds the negotiation decision (a service, or the pinned no-service
decision), the reducer, the wire and result dtypes, the AVERAGE lowering,
the ``_fusion_buckets`` layout with its split metas and the chunk layout
of ``HVD_PIPELINE_THRESHOLD``; the JAX package's plan holds a jitted
program instead, and there is none to hold here. A captured step's plan
(``ops/step_capture.StepPlan``) additionally holds its CUDA Graph, whose
private pool keeps the step's wire buffers from one replay to the next:
the port's form of the JAX package's buffer donation.

Keys are the JAX package's tuples: (op kind, user name, per-rank shape,
dtype, process-set key, reduce op, pre/post scale, hierarchical flag, and
for grouped ops the fusion threshold, wire dtype and chunking knobs).
Capacity and the off switch ride ``HVD_CACHE_CAPACITY`` (reference default
1024; 0 turns caching off). The whole cache is flushed when the runtime
generation changes (``init()``), when a knob override changes
(``envs.override_epoch()``: the autotuner retunes the fusion knobs), and
by :func:`invalidate`: process-set removal, a negotiation service reset,
``shutdown()``.

Statistics surface through :func:`stats` (``hvd.dispatch_cache_stats()``)
and, while a timeline records, as ``PLAN_HIT``/``PLAN_MISS`` instants on
the op's lane. Hits are counted by source: ``call`` (a direct eager
collective), ``flush`` (a fusion-cycle flush), ``step`` (a replayed
captured step), ``gspmd`` (a replayed ``hvd.cached_step``,
``ops/gspmd_cache.py``).

An elastic re-form (``elastic/rendezvous.py``) shelves this world's
restorable plans by the world's shape, (scope, size, rank), before the
store is invalidated (:func:`shelve_for_reform`), and a later world of the
same shape adopts them as its warm pool (:func:`restore_for_reform`, at
the end of ``init()``). A warm plan is never served: a plan's negotiation
decision and its executor are of the world it was built in. A build of
the same key in the new world takes the warm plan's resolved ``stage``
(:func:`take_warm_stage`: the AVERAGE lowering, dtypes and the fusion and
chunk layouts) instead of resolving it again. Captured steps and cached
whole steps hold CUDA Graphs with the old communicator's work: they never
ride the shelf.
"""

from __future__ import annotations

import threading
import zlib as _zlib
from collections import OrderedDict
from typing import Callable

from .. import autotune as _autotune
from .. import conformance as _conformance
from .. import metrics as _metrics
from .. import timeline as _timeline
from ..utils import envs
from ..utils import invariants as _inv


class DispatchPlan:
    """One fully resolved eager dispatch: the negotiation decision
    (``negotiate`` None pins the no-service decision), the payload bytes,
    the timeline labels and ``execute(arg)``, which issues the collective
    with every decision resolved. ``variant`` is ``"fused"`` (one
    collective a wire buffer), ``"chunked"`` (buffers past
    ``HVD_PIPELINE_THRESHOLD`` issued as ``pieces`` chunk collectives),
    ``"step"`` (a captured step's sync) or ``"gspmd"`` (a cached whole
    step). ``stage`` is the host-side resolution a re-formed world of the
    same shape may take again (None: the plan is not restorable)."""

    __slots__ = ("label", "activity", "nbytes", "negotiate", "execute",
                 "variant", "pieces", "stage")

    def __init__(self, label: str, activity: str, nbytes: int | None,
                 negotiate: Callable | None, execute: Callable,
                 variant: str = "fused", pieces: int = 1, stage=None):
        self.label = label
        self.activity = activity
        self.nbytes = nbytes
        self.negotiate = negotiate
        self.execute = execute
        self.variant = variant
        self.pieces = pieces
        self.stage = stage

    def run(self, arg):
        if self.negotiate is None:
            note_negotiation_skip()
        if self.nbytes is not None:
            _autotune.record(self.nbytes)
        return self.execute(arg)


# A cached negative decision: this signature can never be planned.
UNPLANNABLE = object()

_lock = _inv.make_lock("dispatch_cache.lock")
_plans: "OrderedDict[tuple, DispatchPlan]" = OrderedDict()
_epoch: tuple | None = None

_SOURCES = ("call", "flush", "step", "gspmd")
_tls = threading.local()

# The elastic shelf: shape -> {"plans": {key: plan}, "epoch": override
# epoch}, least recently shelved first, and the warm pool of this world.
# A churn cycle of a world of W keeps about 3W shapes live, so the cap
# grows with the largest world shelved.
_SHELF_SHAPES = 32
_shelf: "OrderedDict[tuple, dict]" = OrderedDict()
_warm_plans: dict = {}


class dispatch_source:
    """Context manager tagging plan lookups on this thread with their
    dispatch source (see ``_SOURCES``); untagged lookups count as
    ``"call"``."""

    __slots__ = ("_source", "_prev")

    def __init__(self, source: str):
        self._source = source
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "source", None)
        _tls.source = self._source
        return self

    def __exit__(self, *exc):
        _tls.source = self._prev
        return False


def current_source() -> str:
    return getattr(_tls, "source", None) or "call"


def capacity() -> int:
    """Live capacity from ``HVD_CACHE_CAPACITY`` (0 = caching off), read
    per lookup so tests and the autotuner can flip it."""
    return envs.cache_capacity()


def enabled() -> bool:
    return capacity() > 0


def _current_epoch() -> tuple:
    from .. import runtime
    return (runtime.generation(), envs.override_epoch())


def _flush_locked(count_invalidation: bool) -> None:
    _inv.assert_holding(_lock, "dispatch_cache plan-map flush")
    if count_invalidation and _plans:
        _metrics.DISPATCH_INVALIDATIONS.inc(len(_plans))
    _plans.clear()


def _sync_epoch_locked(epoch: tuple) -> None:
    """A changed runtime generation or knob-override epoch drops every
    plan before the map is read or written."""
    global _epoch
    if _epoch != epoch:
        _flush_locked(count_invalidation=_epoch is not None)
        _epoch = epoch


def lookup(key: tuple, source: str | None = None,
           record_stats: bool = True) -> DispatchPlan | None:
    """The plan for ``key``, or None (a miss, or caching off).
    ``record_stats=False`` is for the capture controller's bookkeeping
    probes: a replay's hit is counted when it is served
    (:func:`note_step_hit`)."""
    if capacity() <= 0:
        return None
    epoch = _current_epoch()
    src = source or current_source()
    with _lock:
        _sync_epoch_locked(epoch)
        plan = _plans.get(key)
        if plan is None:
            if record_stats:
                _metrics.DISPATCH_MISSES.inc()
            return None
        _plans.move_to_end(key)
        if plan is UNPLANNABLE:
            return plan  # neither a hit nor a miss
        if record_stats:
            _metrics.DISPATCH_HITS.inc(labels={"source": src})
    if record_stats:
        _timeline.record_dispatch(plan.label, hit=True)
    return plan


def note_step_hit() -> None:
    """Count one served step-plan replay (``hits_by_source["step"]``)."""
    _metrics.DISPATCH_HITS.inc(labels={"source": "step"})
    _timeline.record_dispatch("step", hit=True)


def note_gspmd_hit() -> None:
    """Count one served cached-step replay (``hits_by_source["gspmd"]``)."""
    _metrics.DISPATCH_HITS.inc(labels={"source": "gspmd"})
    _timeline.record_dispatch("gspmd", hit=True)


def fold_knobs(variant: str, key: tuple, *raw_knob_values) -> tuple:
    """The store key of a whole-step plan: its ``variant``, the raw values
    of every knob its executor bakes in, and the content ``key``; a knob
    changed in ``os.environ`` (which moves no epoch) then never replays a
    stale plan."""
    return (variant,) + tuple(raw_knob_values) + (key,)


def drop(key: tuple) -> bool:
    """Remove one plan; every other plan stays. Returns whether it was
    there."""
    with _lock:
        found = _plans.pop(key, None)
        if found is not None:
            _metrics.DISPATCH_INVALIDATIONS.inc()
    return found is not None


def store(key: tuple, plan: DispatchPlan) -> None:
    """Insert ``plan``, evicting the least recently used past capacity; a
    no-op with caching off."""
    cap = capacity()
    if cap <= 0:
        return
    epoch = _current_epoch()
    with _lock:
        if plan is not UNPLANNABLE and plan.variant == "chunked":
            _metrics.DISPATCH_CHUNKED_BUILDS.inc()
        if plan is not UNPLANNABLE and plan.variant == "step":
            _metrics.DISPATCH_STEP_BUILDS.inc()
        if plan is not UNPLANNABLE and plan.variant == "gspmd":
            _metrics.DISPATCH_GSPMD_BUILDS.inc()
        _sync_epoch_locked(epoch)
        _plans[key] = plan
        _plans.move_to_end(key)
        while len(_plans) > cap:
            _plans.popitem(last=False)
            _metrics.DISPATCH_EVICTIONS.inc()
    _conformance.record(
        "ops/dispatch_cache.py::store", "plan_store",
        (getattr(plan, "variant", "unplannable"),
         _zlib.crc32(repr(key).encode()) & 0xFFFFFFFF))
    if plan is not UNPLANNABLE:
        _timeline.record_dispatch(plan.label, hit=False)


def invalidate(reason: str | None = None) -> int:
    """Flush every cached plan (process-set removal, service reset,
    shutdown), and the warm pool: it held plans of the world that ends.
    Returns the number of plans dropped."""
    global _warm_plans
    del reason
    with _lock:
        n = len(_plans)
        _flush_locked(count_invalidation=True)
        _warm_plans = {}
    return n


def _shelf_cap() -> int:
    """Caller holds ``_lock``; index 1 of a shape is its world size."""
    worlds = [k[1] for k in _shelf if len(k) > 1 and isinstance(k[1], int)]
    return max(_SHELF_SHAPES, 4 * max(worlds, default=0))


def _current_shape() -> tuple | None:
    """This process's world shape: (scope, size, rank)."""
    from .. import runtime
    if not runtime.is_initialized():
        return None
    return ("proc", runtime.size(), runtime.rank())


def _restorable(key: tuple, plan) -> bool:
    if plan is UNPLANNABLE or getattr(plan, "stage", None) is None:
        return False
    # index 4 of an eager key is the process-set key: "g", the global set
    # 0 and rank tuples mean the same in every world; another registered
    # id may name other ranks in a re-formed world, so its plans stay
    # flushed
    if len(key) > 4 and isinstance(key[4], int) \
            and not isinstance(key[4], bool):
        return key[4] == 0
    return True


def shelve_for_reform() -> int:
    """Move this world's restorable plans onto the shelf of its shape
    (the re-form's teardown, before the store is invalidated); warm-pool
    plans no build took ride along. Returns how many were shelved."""
    global _warm_plans
    if not envs.elastic_warm_enabled() or capacity() <= 0:
        return 0
    shape = _current_shape()
    if shape is None:
        return 0
    epoch = envs.override_epoch()
    with _lock:
        keep = {k: p for k, p in _plans.items() if _restorable(k, p)}
        for k in keep:
            _plans.pop(k, None)
        for k, p in _warm_plans.items():
            keep.setdefault(k, p)
        _warm_plans = {}
        if not keep:
            return 0
        merged = _shelf.get(shape)
        if merged is not None and merged["epoch"] == epoch:
            merged["plans"].update(keep)
        else:
            _shelf[shape] = {"plans": keep, "epoch": epoch}
        _shelf.move_to_end(shape)
        cap = _shelf_cap()
        while len(_shelf) > cap:
            _shelf.popitem(last=False)
    _conformance.record("ops/dispatch_cache.py::shelve_for_reform",
                        "shelve", (shape, len(keep)))
    return len(keep)


def restore_for_reform() -> int:
    """Adopt the shelf entry of this (re-formed) world's shape as the warm
    pool (the end of ``init()``). Returns the pool's size: 0 where the
    shape was never shelved, warm re-form is off, or a knob override
    moved since (the stages baked the knobs of their time)."""
    global _warm_plans
    if not envs.elastic_warm_enabled() or capacity() <= 0:
        return 0
    shape = _current_shape()
    if shape is None:
        return 0
    with _lock:
        entry = _shelf.pop(shape, None)
        if entry is None:
            return 0
        if entry["epoch"] != envs.override_epoch():
            _metrics.DISPATCH_INVALIDATIONS.inc(len(entry["plans"]))
            return 0
        _warm_plans = entry["plans"]
    _conformance.record("ops/dispatch_cache.py::restore_for_reform",
                        "restore", (shape, len(entry["plans"])))
    return len(entry["plans"])


def take_warm_stage(key: tuple):
    """The resolved stage of the warm plan of ``key``, taken out of the
    pool, or None. A build of the same signature in a re-formed world
    uses it instead of resolving it again."""
    with _lock:
        warm = _warm_plans.pop(key, None) if _warm_plans else None
    if warm is None:
        return None
    _metrics.ELASTIC_WARM_REUSE.inc(labels={"kind": "plan"})
    _conformance.record(
        "ops/dispatch_cache.py::_warm_graft_locked", "graft",
        (warm.variant, _zlib.crc32(repr(key).encode()) & 0xFFFFFFFF))
    return warm.stage


def note_negotiation_skip() -> None:
    """Account one negotiation round skipped: the plan pinned the
    no-service decision."""
    _metrics.DISPATCH_NEGOTIATION_SKIPS.inc()


def stats() -> dict:
    """Plan-cache counters (``hvd.dispatch_cache_stats()``), the JAX
    package's dict."""
    by_source = {s: 0 for s in _SOURCES}
    for labelitems, v in _metrics.DISPATCH_HITS.series().items():
        by_source[dict(labelitems).get("source", "call")] = int(v)
    warm_reuses = sum(
        int(v) for labelitems, v in
        _metrics.ELASTIC_WARM_REUSE.series().items()
        if dict(labelitems).get("kind") in ("plan", "step"))
    with _lock:
        size = len(_plans)
        warm_pool = len(_warm_plans)
    return {
        "enabled": enabled(),
        "capacity": capacity(),
        "size": size,
        "hits": sum(by_source.values()),
        "hits_by_source": by_source,
        "misses": int(_metrics.DISPATCH_MISSES.value()),
        "invalidations": int(_metrics.DISPATCH_INVALIDATIONS.value()),
        "evictions": int(_metrics.DISPATCH_EVICTIONS.value()),
        "negotiation_skips": int(
            _metrics.DISPATCH_NEGOTIATION_SKIPS.value()),
        "chunked_builds": int(_metrics.DISPATCH_CHUNKED_BUILDS.value()),
        "step_builds": int(_metrics.DISPATCH_STEP_BUILDS.value()),
        "gspmd_builds": int(_metrics.DISPATCH_GSPMD_BUILDS.value()),
        # the elastic warm re-form: plans waiting in this world's warm
        # pool, and stages taken from it
        "warm_pool": warm_pool,
        "warm_reuses": warm_reuses,
    }


def reset_stats() -> None:
    for inst in (_metrics.DISPATCH_HITS, _metrics.DISPATCH_MISSES,
                 _metrics.DISPATCH_INVALIDATIONS,
                 _metrics.DISPATCH_EVICTIONS,
                 _metrics.DISPATCH_NEGOTIATION_SKIPS,
                 _metrics.DISPATCH_CHUNKED_BUILDS,
                 _metrics.DISPATCH_STEP_BUILDS,
                 _metrics.DISPATCH_GSPMD_BUILDS):
        inst.reset()


def reset() -> None:
    """Tests / teardown: drop plans, shelves, the warm pool and
    counters."""
    global _epoch, _warm_plans
    with _lock:
        _plans.clear()
        _epoch = None
        _shelf.clear()
        _warm_plans = {}
    reset_stats()
