"""Metrics registry: counters, gauges and histograms with labels, their
Prometheus exposition and a JSON-shaped dump (port of
``horovod_tpu/metrics.py``).

Two surfaces read the instruments back:

* ``GET /metrics``, Prometheus text format 0.0.4, served by the KV server
  (``runner/http_kv.py``) and, per worker, by :func:`serve` on
  ``HVD_METRICS_PORT`` + the process's rank (:func:`maybe_serve`, called
  from ``runtime.init``);
* :func:`metrics_dump` (``hvd.metrics_dump()``), the same samples as
  dicts.

A process is a rank, so there is one process-wide store: the JAX package's
per-``RankContext`` stores of its loopback worlds (threads of one process
acting as ranks) have no counterpart here. Exposition labels every series
with this process's launcher rank as ``rank`` unless the series names a
rank of its own (the straggler counter names the straggler), in which case
the reporter's rank is ``reporter``, as in the reference.

The catalog below holds the instruments whose producers the port has,
under the reference's literal names and help texts: the negotiation
rounds and their times, submit lags, straggler rounds, the coordinator
ResponseCache's hits and misses, KV operations, retries and give-ups, the
health watchdog's beats, beat errors and peer failures, fault fires, and
the fusion and plan machinery's: flushes by trigger and tenant, pending
bytes, the executor's in-flight depth, the QoS gate's waits, grants,
shares, sheds and quota blocks, the step capture's phase and events, and
the dispatch plan cache's hits by source, misses, invalidations,
evictions, negotiation skips and builds. Beside them, the port's own
(:data:`PORT_ONLY`): the dropless expert layer's rows a held expert and
imbalance, tallied on the device and read only when the registry is.

With ``HVD_METRICS=0`` every instrument not marked ``always`` records
nothing (one cached bool). The retry counters are ``always``: they back
``health_stats()["retries"]``, and so are the plan cache's, which back
``dispatch_cache_stats()``.
"""

from __future__ import annotations

import threading

from .utils import envs

__all__ = [
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "enabled", "refresh", "set_enabled", "instruments", "snapshot",
    "delta", "prometheus_text", "dump", "metrics_dump", "serve",
    "maybe_serve", "stop_serving", "reset",
]

_force_enabled: bool | None = None  # a test's override; None: the knob


def _read_enabled() -> bool:
    if _force_enabled is not None:
        return _force_enabled
    return envs.get_bool(envs.METRICS, True)


_enabled = _read_enabled()


def enabled() -> bool:
    """Whether instruments record (``HVD_METRICS``, default on)."""
    return _enabled


def refresh() -> None:
    """Read ``HVD_METRICS`` again."""
    global _enabled
    _enabled = _read_enabled()


def set_enabled(value: bool | None) -> None:
    """Force recording on or off; ``None`` goes back to the knob."""
    global _force_enabled
    _force_enabled = value
    refresh()


# {(name, sorted label items): value}; a histogram's value is a _Hist
_mu = threading.Lock()  # a leaf: nothing else is taken under it
_values: dict = {}


class _Hist:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * nbuckets  # per bucket; cumulated at exposition
        self.sum = 0.0
        self.count = 0


_registry: "dict[str, _Instrument]" = {}


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labels=(),
                 always: bool = False):
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self.always = always

    def _on(self) -> bool:
        return _enabled or self.always

    def _key(self, labels) -> tuple:
        if labels is None:
            if self.labelnames:
                raise ValueError(
                    f"{self.name} requires labels {self.labelnames}")
            return (self.name, ())
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return (self.name,
                tuple(sorted((k, str(v)) for k, v in labels.items())))

    def series(self) -> dict:
        """``{label items: value}`` of this instrument."""
        with _mu:
            return {k[1]: v for k, v in _values.items() if k[0] == self.name}

    def value(self, labels=None, default=0.0):
        key = self._key(labels)
        with _mu:
            return _values.get(key, default)

    def reset(self) -> None:
        """Drop this instrument's series."""
        with _mu:
            for k in [k for k in _values if k[0] == self.name]:
                del _values[k]

    def bind(self, labels=None) -> "_Bound":
        """A handle on one label set, validated once."""
        return _Bound(self, self._key(labels))


def _rec_add(inst: _Instrument, key: tuple, amount: float) -> None:
    if inst._on():
        with _mu:
            _values[key] = _values.get(key, 0.0) + amount


def _rec_set(inst: _Instrument, key: tuple, value: float) -> None:
    if inst._on():
        with _mu:
            _values[key] = float(value)


def _rec_observe(inst: "Histogram", key: tuple, value: float) -> None:
    if not inst._on():
        return
    with _mu:
        h = _values.get(key)
        if h is None:
            h = _values[key] = _Hist(len(inst.buckets))
        for i, bound in enumerate(inst.buckets):
            if value <= bound:
                h.counts[i] += 1
                break
        # past the last bound it counts only in the implicit +Inf bucket
        h.sum += value
        h.count += 1


class _Bound:
    __slots__ = ("inst", "key")

    def __init__(self, inst: _Instrument, key: tuple):
        self.inst = inst
        self.key = key

    def inc(self, amount: float = 1) -> None:
        _rec_add(self.inst, self.key, amount)

    def set(self, value: float) -> None:
        _rec_set(self.inst, self.key, value)

    def observe(self, value: float) -> None:
        _rec_observe(self.inst, self.key, value)


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1, labels=None) -> None:
        _rec_add(self, self._key(labels), amount)


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, labels=None) -> None:
        _rec_set(self, self._key(labels), value)

    def add(self, amount: float, labels=None) -> None:
        _rec_add(self, self._key(labels), amount)


# Negotiation rounds over an HTTP KV store span milliseconds (one host) to
# seconds (many hosts); the straggler threshold (1 s) lies inside.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str, labels=(),
                 buckets=DEFAULT_BUCKETS, always: bool = False):
        super().__init__(name, help, labels, always)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, labels=None) -> None:
        _rec_observe(self, self._key(labels), value)


def _register(inst: _Instrument) -> _Instrument:
    if inst.name in _registry:
        raise ValueError(f"metric {inst.name!r} already registered")
    _registry[inst.name] = inst
    return inst


def counter(name: str, help: str, labels=(), always: bool = False) -> Counter:
    return _register(Counter(name, help, labels, always))


def gauge(name: str, help: str, labels=(), always: bool = False) -> Gauge:
    return _register(Gauge(name, help, labels, always))


def histogram(name: str, help: str, labels=(), buckets=DEFAULT_BUCKETS,
              always: bool = False) -> Histogram:
    return _register(Histogram(name, help, labels, buckets, always))


def instruments() -> dict:
    """The catalog: ``{name: instrument}``."""
    return dict(_registry)


# --------------------------------------------------------------------------
# the catalog (reference metrics.py:371-551, the instruments whose producers
# the port has)
# --------------------------------------------------------------------------

# -- negotiation (engine_service.KVTransport / DynamicService) -------------
NEGOTIATION_ROUNDS = counter(
    "hvd_negotiation_rounds_total",
    "Busy negotiation rounds (cycles with local work pending).",
    labels=("process_set",))
NEGOTIATION_ROUND_SECONDS = histogram(
    "hvd_negotiation_round_seconds",
    "Wall time of one busy negotiation exchange (publish -> all "
    "members' frames gathered).",
    labels=("process_set",))
NEGOTIATION_SUBMIT_LAG = histogram(
    "hvd_negotiation_submit_lag_seconds",
    "Per-rank submit->ready breakdown: how far behind the round's first "
    "submitter each rank's frame reached the KV server (server receipt "
    "clock, skew-free).",
    labels=("rank",))
STRAGGLER_ROUNDS = counter(
    "hvd_straggler_rounds_total",
    "Rounds in which the labeled global rank was last to submit by more "
    "than HVD_STRAGGLER_THRESHOLD (the stall-check analog).",
    labels=("rank",))
RESPONSE_CACHE_HITS = counter(
    "hvd_response_cache_hits_total",
    "Negotiation requests served locally from the coordinator "
    "ResponseCache (HVD_RESPONSE_CACHE) — zero KV rounds.",
    labels=("process_set",))
RESPONSE_CACHE_MISSES = counter(
    "hvd_response_cache_misses_total",
    "Cacheable negotiation requests that took a full round (entry "
    "absent, unconfirmed, invalidated, or a join in flight).",
    labels=("process_set",))

# -- KV transport (runner/http_kv.KVClient) --------------------------------
KV_OPS = counter(
    "hvd_kv_ops_total",
    "KV client operations by verb (gather = one server-side long-poll); "
    "divide by hvd_negotiation_rounds_total for KV ops/round.",
    labels=("op",))

# -- retry ladder (utils/retry.py; backs health_stats()["retries"]) --------
RETRY_RETRIES = counter(
    "hvd_retry_retries_total",
    "Retries taken per RPC/KV site (the HVD_RETRY_* backoff ladder).",
    labels=("site",), always=True)
RETRY_GIVEUPS = counter(
    "hvd_retry_giveups_total",
    "Retryable failures that exhausted attempts/deadline per site.",
    labels=("site",), always=True)

# -- health watchdog (health.py) -------------------------------------------
HEALTH_BEATS = counter(
    "hvd_health_beats_total",
    "Liveness beats published by this rank's watchdogs.")
HEALTH_BEAT_ERRORS = counter(
    "hvd_health_beat_errors_total",
    "Beat publishes that failed through the whole retry ladder.")
HEALTH_PEER_FAILURES = counter(
    "hvd_health_peer_failures_total",
    "Peer-death decisions, labeled with the dead global rank.",
    labels=("rank",))

# -- fault injection (utils/faults.py) -------------------------------------
FAULT_FIRES = counter(
    "hvd_fault_fires_total",
    "Injected faults fired per site (HVD_FAULT_SPEC chaos runs only).",
    labels=("site",))


# -- fusion scheduler (ops/fusion_cycle.py) --------------------------------
FUSION_FLUSHES = counter(
    "hvd_fusion_flushes_total",
    "Fusion-cycle queue flushes by trigger and tenant (process set).",
    labels=("process_set", "trigger"))
FUSION_FLUSHED_TENSORS = counter(
    "hvd_fusion_flushed_tensors_total",
    "Tensors coalesced through fusion-cycle flushes, per tenant.",
    labels=("process_set",))
FUSION_FLUSHED_BYTES = counter(
    "hvd_fusion_flushed_bytes_total",
    "Payload bytes coalesced through fusion-cycle flushes, per tenant.",
    labels=("process_set",))
FUSION_ENQUEUED_TENSORS = counter(
    "hvd_fusion_enqueued_tensors_total",
    "Async submissions accepted into fusion-cycle pending queues, per "
    "tenant.",
    labels=("process_set",))
FUSION_PENDING_BYTES = gauge(
    "hvd_fusion_pending_bytes",
    "Bytes currently queued across all fusion-cycle pending queues "
    "(backpressure drains at HVD_FUSION_MAX_PENDING).")
PIPELINE_INFLIGHT_DEPTH = gauge(
    "hvd_pipeline_inflight_depth",
    "Device-incomplete earlier flushes observed at the last executor "
    "slot admission (docs/pipeline.md overlap semantics).")

# -- multi-tenant QoS (qos.py; docs/qos.md) --------------------------------
QOS_ADMISSION_WAIT = histogram(
    "hvd_qos_admission_wait_seconds",
    "Time a flush batch spent parked in the QoS admission gate (submit "
    "-> grant), per tenant (process set).",
    labels=("process_set",))
QOS_GRANTED_BYTES = counter(
    "hvd_qos_granted_bytes_total",
    "Payload bytes granted into the flush executor's slots by the QoS "
    "arbiter, per tenant.",
    labels=("process_set",))
QOS_SLOT_SHARE = gauge(
    "hvd_qos_slot_share",
    "Tenant's cumulative share (0-1) of all bytes granted into the "
    "executor slots — converges to the configured weight ratio under "
    "saturation.",
    labels=("process_set",))
QOS_SHED = counter(
    "hvd_qos_shed_total",
    "Async submissions shed at enqueue by a tenant pending-bytes quota "
    "(policy=shed); the handle raises QosAdmissionError.",
    labels=("process_set",))
QOS_QUOTA_BLOCKS = counter(
    "hvd_qos_quota_blocks_total",
    "Producer enqueues that blocked on a tenant pending-bytes quota "
    "(policy=block) until in-flight work settled.",
    labels=("process_set",))

# -- step capture (ops/step_capture.py) ------------------------------------
STEP_CAPTURE_PHASE = gauge(
    "hvd_step_capture_phase",
    "Capture lifecycle phase: 0 idle, 1 record, 2 replay (armed), "
    "3 replayed, 4 bypass.")
STEP_CAPTURE_STEPS = counter(
    "hvd_step_capture_steps_total",
    "Step-capture lifecycle events by kind (recorded / replayed / "
    "fallback / invalidated / uncapturable).",
    labels=("event",))

# -- dispatch plan cache (ops/dispatch_cache.py; backs
#    hvd.dispatch_cache_stats() -- always on) ------------------------------
DISPATCH_HITS = counter(
    "hvd_dispatch_plan_hits_total",
    "Dispatch-plan cache hits by source (call / flush / step / gspmd).",
    labels=("source",), always=True)
DISPATCH_MISSES = counter(
    "hvd_dispatch_plan_misses_total",
    "Dispatch-plan cache misses (plan built per call).", always=True)
DISPATCH_INVALIDATIONS = counter(
    "hvd_dispatch_plan_invalidations_total",
    "Plans dropped by epoch flushes / service resets / removals.",
    always=True)
DISPATCH_EVICTIONS = counter(
    "hvd_dispatch_plan_evictions_total",
    "Plans LRU-evicted past HVD_CACHE_CAPACITY.", always=True)
DISPATCH_NEGOTIATION_SKIPS = counter(
    "hvd_dispatch_negotiation_skips_total",
    "Negotiation rounds skipped (pinned no-service decision or engine "
    "response-cache hit).", always=True)
DISPATCH_CHUNKED_BUILDS = counter(
    "hvd_dispatch_chunked_builds_total",
    "Chunk-pipelined plan variants built (fused wire buffers past "
    "HVD_PIPELINE_THRESHOLD).", always=True)
DISPATCH_STEP_BUILDS = counter(
    "hvd_dispatch_step_builds_total",
    "Whole-step capture plans built (ops/step_capture.py).", always=True)
DISPATCH_GSPMD_BUILDS = counter(
    "hvd_dispatch_gspmd_builds_total",
    "Compiled GSPMD step programs built (ops/gspmd_cache.py: one "
    "lower+compile per new step signature).", always=True)

# -- cached whole steps (ops/gspmd_cache.py; backs hvd.gspmd_cache_stats())
GSPMD_CACHE_PHASE = gauge(
    "hvd_gspmd_cache_phase",
    "GSPMD cached-step lifecycle phase (the step-capture vocabulary): "
    "0 idle, 1 record (building), 3 replayed, 4 bypass.")
GSPMD_CACHE_STEPS = counter(
    "hvd_gspmd_cache_steps_total",
    "GSPMD cached-step lifecycle events by kind (recorded / replayed / "
    "fallback / invalidated / bypass).",
    labels=("event",))
GSPMD_PASSTHROUGH_SYNCS = counter(
    "hvd_gspmd_passthrough_syncs_total",
    "Gradient syncs traced through DistributedOptimizer's GSPMD "
    "passthrough branch (once per TRACE, not per step — frozen while "
    "cached steps replay).")

# -- elastic recovery (elastic/state.py) ----------------------------------
ELASTIC_EVENTS = counter(
    "hvd_elastic_events_total",
    "Elastic membership + recovery events by kind: scripted churn "
    "(add / remove / preempt), worker-side recoveries (hosts-updated "
    "interrupt, peer-failure restore).",
    labels=("kind",))
ELASTIC_REFORM_SECONDS = histogram(
    "hvd_elastic_reform_seconds",
    "Worker-side re-form duration: interrupt/failure caught -> "
    "re-rendezvoused into the new round, state synced, training "
    "re-entered (the recovery-time SLO numerator).",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 45.0, 90.0, 180.0))
ELASTIC_STEPS_LOST = counter(
    "hvd_elastic_steps_lost_total",
    "In-flight steps rolled back by a failure restore (commit-per-step "
    "convention: each HorovodInternalError recovery counts its one "
    "uncommitted step; graceful interrupts count zero).")
ELASTIC_WARM_REUSE = counter(
    "hvd_elastic_warm_reuse_total",
    "Shape-keyed state reused across an elastic re-form, by kind: "
    "plan (dispatch plans grafted from the warm pool), step (whole-step "
    "capture plans), response (coordinator response-cache entries "
    "re-armed after the warm confirmation round).",
    labels=("kind",), always=True)

# -- closed-loop autoscaling (elastic/policy.py) ---------------------------
ELASTIC_STEP_SECONDS = histogram(
    "hvd_elastic_step_seconds",
    "Wall time between consecutive elastic state commits (the per-step "
    "latency the autoscale policy's SLO rule watches).",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0))
ELASTIC_SLO_VIOLATIONS = counter(
    "hvd_elastic_slo_violations_total",
    "Committed steps whose commit-to-commit wall time exceeded the "
    "HVD_AUTOSCALE_SLO_MS target (recorded only with a nonzero target).")
ELASTIC_POLICY_DECISIONS = counter(
    "hvd_elastic_policy_decisions_total",
    "Autoscale policy decisions by action (add / remove / evict / hold) "
    "and reason (slo-breach / idle / straggler / stale-round / protected "
    "/ restore-cost / error); rank names the blamed global rank on "
    "evictions, empty otherwise.",
    labels=("action", "reason", "rank"), always=True)

# -- checkpoint state plane (checkpoint.py) ------------------------------
CKPT_SNAPSHOT_SECONDS = histogram(
    "hvd_ckpt_snapshot_seconds",
    "Background snapshot duration on the writer thread: this rank's "
    "shard pickled + written + fsync-renamed (rank 0 adds the manifest "
    "wait/write) — off the training critical path by construction.",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0))
CKPT_SHARDS_WRITTEN = counter(
    "hvd_ckpt_shards_written_total",
    "Snapshot shards durably written by this rank (one per triggered "
    "snapshot that completed its atomic rename).")
CKPT_RESTORE_SECONDS = histogram(
    "hvd_ckpt_restore_seconds",
    "Re-form state re-sync duration: manifest-agree round entered -> "
    "attributes restored (peer shard pulls, or the degraded rank-0 "
    "broadcast). The restore half of the recovery-SLO lane.",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0))
CKPT_PEER_SHARDS_PULLED = counter(
    "hvd_ckpt_peer_shards_pulled_total",
    "Shards this rank pulled from survivors during peer-restore, by "
    "transport (hub = in-world loopback rendezvous, kv = the fallback "
    "KV channel).",
    labels=("transport",))
CKPT_RESTORE_BYTES = counter(
    "hvd_ckpt_restore_bytes_total",
    "State-restore payload bytes this rank received, by source (rank0 "
    "= served by rank 0: degraded broadcasts plus shards rank 0 "
    "happened to own; peer = shards served by other survivors). The "
    "recovery lane gates peer-restore moving strictly fewer rank0 "
    "bytes than the broadcast baseline.",
    labels=("source",))
CKPT_DEGRADED_RESTORES = counter(
    "hvd_ckpt_degraded_restores_total",
    "Re-forms that fell back to the rank-0 full-tree broadcast, by "
    "reason (quorum = too few consistent survivors, structure = the "
    "joiner's state tree shape disagreed, pull-failed = shard pulls "
    "exhausted their failover retry).",
    labels=("reason",))


# -- the dropless expert layer (parallel/moe.py), the port's own -----------
MOE_EXPERT_ROWS = counter(
    "hvd_moe_expert_rows_total",
    "Token rows the dropless expert layer routed to each expert it holds, "
    "by layer and global expert index (tallied on the device, read when "
    "the registry is read).",
    labels=("layer", "expert"))
MOE_EXPERT_IMBALANCE = gauge(
    "hvd_moe_expert_imbalance",
    "The held expert with the most routed rows over the mean of the held "
    "experts, by layer, over the rows tallied so far (1 is even).",
    labels=("layer",))
# instruments the JAX package has no counterpart of
PORT_ONLY = frozenset({MOE_EXPERT_ROWS.name, MOE_EXPERT_IMBALANCE.name})

# (layer, first held expert) -> rows per held expert, a device tensor
_tallies: dict = {}


def tally_expert_rows(layer: str, first: int, rows) -> None:
    """Add ``rows`` (a tensor, one count per held expert, experts ``first``
    on) to ``layer``'s tally of :data:`MOE_EXPERT_ROWS`. The sum stays on
    the tensor's device: nothing here waits for it. It is read, and the
    gauge set, when the registry is next read (:func:`snapshot`,
    :func:`dump`, :func:`prometheus_text`)."""
    if not MOE_EXPERT_ROWS._on():
        return
    with _mu:  # the add is queued on the device, not waited for
        cur = _tallies.get((layer, first))
        if cur is None:
            _tallies[layer, first] = rows.detach().clone()
        else:
            cur += rows.detach()


def _settle_tallies() -> None:
    """Move the device tallies into the series (the one place that waits
    for the device) and set each tallied layer's imbalance."""
    with _mu:
        pending = list(_tallies.items())
        _tallies.clear()
    for (layer, first), rows in pending:
        for i, n in enumerate(rows.tolist()):
            MOE_EXPERT_ROWS.inc(n, labels={"layer": layer,
                                           "expert": first + i})
    for layer in sorted({layer for (layer, _), _ in pending}):
        got = [v for k, v in MOE_EXPERT_ROWS.series().items()
               if dict(k)["layer"] == layer]
        mean = sum(got) / len(got)
        MOE_EXPERT_IMBALANCE.set(max(got) / mean if mean > 0 else 1.0,
                                 labels={"layer": layer})


# --------------------------------------------------------------------------
# snapshot, delta, exposition
# --------------------------------------------------------------------------

def snapshot() -> dict:
    """A flat copy: ``{(name, label items): value}``; a histogram gives
    ``name_sum`` and ``name_count`` entries, so deltas stay numbers."""
    _settle_tallies()
    with _mu:
        items = list(_values.items())
    out: dict = {}
    for (name, labelitems), v in items:
        if isinstance(v, _Hist):
            out[(name + "_sum", labelitems)] = v.sum
            out[(name + "_count", labelitems)] = v.count
        else:
            out[(name, labelitems)] = v
    return out


def delta(new: dict, old: dict) -> dict:
    """``new - old`` per series (a series absent from ``old`` counts from
    zero)."""
    return {k: v - old.get(k, 0.0) for k, v in new.items()}


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _process_rank_label() -> str:
    r = envs.launcher_rank()
    return "" if r is None else str(r)


def _labelled(labelitems, rank: str) -> tuple:
    """The series' labels with this process's rank added as ``rank``, or
    as ``reporter`` where the series names a rank of its own."""
    labels = dict(labelitems)
    if rank:
        if "rank" not in labels:
            labels["rank"] = rank
        elif "reporter" not in labels:
            labels["reporter"] = rank
    return tuple(sorted(labels.items()))


def _exposed() -> list:
    """``[(name, label items with the rank, value)]`` of every series."""
    _settle_tallies()
    rank = _process_rank_label()
    with _mu:
        items = list(_values.items())
    out = []
    for (name, labelitems), v in items:
        if isinstance(v, _Hist):
            copy = _Hist(len(v.counts))
            copy.counts, copy.sum, copy.count = list(v.counts), v.sum, v.count
            v = copy
        out.append((name, _labelled(labelitems, rank), v))
    return out


def _plain_labels(labelitems) -> str:
    if not labelitems:
        return ""
    return ("{" + ",".join(f'{k}="{_escape(str(v))}"'
                           for k, v in labelitems) + "}")


def _fmt_num(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text() -> str:
    """The ``/metrics`` payload: every instrument's HELP and TYPE lines,
    samples or not, then one line a series (a histogram: its cumulative
    buckets, ``_sum`` and ``_count``)."""
    per_name: dict[str, list[str]] = {}
    for name, labelitems, v in _exposed():
        lines = per_name.setdefault(name, [])
        labels = _plain_labels(labelitems)
        inst = _registry.get(name)
        if isinstance(v, _Hist):
            cum = 0
            base = list(labelitems)
            for i, bound in enumerate(inst.buckets if inst else ()):
                cum += v.counts[i]
                bl = _plain_labels(tuple(sorted(base + [("le",
                                                         f"{bound:g}")])))
                lines.append(f"{name}_bucket{bl} {cum}")
            bl = _plain_labels(tuple(sorted(base + [("le", "+Inf")])))
            lines.append(f"{name}_bucket{bl} {v.count}")
            lines.append(f"{name}_sum{labels} {_fmt_num(v.sum)}")
            lines.append(f"{name}_count{labels} {v.count}")
        else:
            lines.append(f"{name}{labels} {_fmt_num(v)}")
    out: list[str] = []
    for name, inst in sorted(_registry.items()):
        out.append(f"# HELP {name} {_escape(inst.help)}")
        out.append(f"# TYPE {name} {inst.kind}")
        out.extend(sorted(per_name.get(name, ())))
    return "\n".join(out) + "\n"


def dump() -> dict:
    """``hvd.metrics_dump()``: every instrument with its series, as
    dicts (labels carry this process's rank, as on ``/metrics``)."""
    out: dict = {}
    for name, inst in sorted(_registry.items()):
        entry = {"type": inst.kind, "help": inst.help,
                 "labels": list(inst.labelnames), "series": []}
        if inst.kind == "histogram":
            entry["buckets"] = list(inst.buckets)
        out[name] = entry
    for name, labelitems, v in _exposed():
        labels = dict(labelitems)
        if isinstance(v, _Hist):
            out[name]["series"].append({
                "labels": labels, "count": v.count, "sum": v.sum,
                "bucket_counts": list(v.counts)})
        else:
            out[name]["series"].append({"labels": labels, "value": v})
    for entry in out.values():
        entry["series"].sort(key=lambda s: sorted(s["labels"].items()))
    return out


metrics_dump = dump  # hvd.metrics_dump


# --------------------------------------------------------------------------
# the per-worker exposition server (HVD_METRICS_PORT)
# --------------------------------------------------------------------------

_server = None


def serve(port: int = 0, host: str = "0.0.0.0") -> int:
    """Serve ``GET /metrics`` on ``port`` from a daemon thread; returns the
    bound port. A running server keeps its port."""
    global _server
    with _mu:
        if _server is not None:
            return _server.server_address[1]
    import http.server

    class _Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # no stderr line per request
            pass

        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            write_prometheus(self)

    class _Server(http.server.ThreadingHTTPServer):
        daemon_threads = True
        allow_reuse_address = True

    srv = _Server((host, port), _Handler)
    with _mu:
        if _server is not None:  # another thread started one first
            srv.server_close()
            return _server.server_address[1]
        _server = srv
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="hvd-metrics-server").start()
    return srv.server_address[1]


def write_prometheus(handler) -> None:
    """Answer an HTTP GET on ``handler`` with :func:`prometheus_text`."""
    body = prometheus_text().encode()
    handler.send_response(200)
    handler.send_header("Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


def maybe_serve() -> int | None:
    """Start :func:`serve` on ``HVD_METRICS_PORT`` + this process's rank
    when that knob is set (co-hosted ranks do not collide); returns the
    port, or None. A port already taken is logged, not raised."""
    if not _enabled:
        return None
    base = envs.get_int(envs.METRICS_PORT, 0)
    if base <= 0:
        return None
    port = base + (envs.launcher_rank() or 0)
    try:
        return serve(port)
    except OSError as e:
        from .utils import logging as hvd_logging
        hvd_logging.warning("metrics exposition server failed on port "
                            "%d: %s", port, e)
        return None


def stop_serving() -> None:
    global _server
    with _mu:
        srv, _server = _server, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()


def reset() -> None:
    """Drop every sample, device tallies too; the catalog stays."""
    with _mu:
        _values.clear()
        _tallies.clear()
