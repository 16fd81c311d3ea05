"""Multi-tenant QoS for the collective engine: priority classes,
weighted-fair admission, and load shedding (port of
``horovod_tpu/qos.py``, whose docs/qos.md gives the grammar).

The fusion scheduler (``ops/fusion_cycle.py``) runs one FIFO flush
pipeline shared by every process set; this module puts tenancy on it,
one tenant a process set:

* **Priority classes** — :func:`set_qos` attaches ``(priority tier,
  DRR weight, pending-bytes quota, block/shed policy)`` to a process
  set; ``HVD_QOS_*`` knobs configure defaults and per-tenant classes
  from the environment (docs/qos.md grammar).
* **Weighted-fair admission** — :class:`QosGate` sits between
  ``flush_queue``'s batch submission and the pipelined executor's FIFO:
  batches park per tenant, and an arbiter grants them into the
  ``HVD_MAX_INFLIGHT_FLUSHES`` slots by strict-priority tiers with
  deficit-round-robin (byte-weighted) inside a tier, preserving
  per-signature FIFO within a tenant.
* **Admission control / shedding** — per-tenant pending-bytes quotas
  enforced at enqueue: ``block`` backpressures the producer until
  granted work settles; ``shed`` fails the submission with a typed
  :class:`~horovod_tpu.exceptions.QosAdmissionError` on the handle.

Determinism contract. In a world of one process a rank every rank's
executor must issue the identical collective sequence (NCCL and gloo pair
collectives by issue order), so grant order must be a pure function of
the submission stream and the static QoS config, never of completion
timing:

* gate state mutates ONLY at rank-deterministic program points — batch
  submission (a flush trigger on the user thread), handle observation
  (``synchronize``/first ``poll``: forced release), name-reuse guards,
  and ``flush_all``/``abort``;
* the **arbitration window** (``HVD_QOS_WINDOW``): a submission pump
  grants parked *negotiated* (svc) batches down to the window in fair
  order — the window is the deterministic reordering span;
* **single-controller** batches (no peer whose issue order could
  diverge: in the port, a batch over a set of one rank) additionally
  grant on executor demand: work-conserving true priority scheduling;
* the starvation valve ages by **grant count**, never wall-clock
  (``HVD_QOS_STARVE_LIMIT``): every N grants the globally oldest parked
  batch is served regardless of tier, so strict priority cannot park a
  bulk tenant forever;
* the ``shed`` quota is measured on *unacknowledged* bytes (enqueue ->
  ``synchronize`` return — both rank-deterministic stream points), so
  every member rank sheds the identical submissions; the ``block``
  quota waits on *granted-but-unsettled + parked single-controller*
  bytes — all drained by the executor with no producer action — and
  never mutates the gate (a wait that re-ordered grants would be a
  completion-timing input, and a wait that only a batch the gate still
  holds could satisfy would deadlock).

Instrumentation: ``hvd_qos_admission_wait_seconds`` /
``hvd_qos_granted_bytes_total`` / ``hvd_qos_slot_share`` /
``hvd_qos_shed_total`` / ``hvd_qos_quota_blocks_total`` plus ``QOS_*``
instants on the timeline's ``qos`` lane. ``HVD_QOS=0``
(the default) keeps the single-tenant FIFO pipeline byte-for-byte.
"""

from __future__ import annotations

import threading
from collections import deque

from . import conformance as _conformance
from . import metrics as _metrics
from . import timeline as _timeline
from .exceptions import QosAdmissionError
from .utils import envs
from .utils import invariants as _inv

__all__ = ["QosAdmissionError", "QosClass", "QosGate", "set_qos",
           "configure_label", "get_class", "tenant_label", "classes",
           "qos_stats", "enabled", "reset"]

POLICIES = ("block", "shed")


def enabled() -> bool:
    """Whether the multi-tenant QoS engine is on (``HVD_QOS``)."""
    return envs.qos_enabled()


def tenant_label(pset) -> str:
    """Tenant label for a process set — THE derivation shared with the
    per-tenant fusion/negotiation registry counters
    (``engine_service._set_key``), with the global set's ``"0"`` key
    spelled ``"global"``. One function, so QoS classes, fusion counters,
    and negotiation instruments can never drift apart on a tenant's
    identity."""
    if pset is None or getattr(pset, "is_global", True):
        return "global"
    from . import engine_service as _es
    key = _es._set_key(pset)
    return "global" if key == "0" else key


class QosClass:
    """One tenant's service class: strict-priority ``priority`` tier
    (higher = served first), DRR ``weight`` (byte share within a tier),
    ``quota`` pending bytes (0 = unlimited), and the quota ``policy``
    (``block`` backpressure / ``shed`` with QosAdmissionError)."""

    __slots__ = ("priority", "weight", "quota", "policy")

    def __init__(self, priority: int = 0, weight: float = 1.0,
                 quota: int = 0, policy: str = "block"):
        if weight <= 0.0:
            raise ValueError(f"QoS weight must be > 0, got {weight}")
        if policy not in POLICIES:
            raise ValueError(
                f"QoS policy must be one of {POLICIES}, got {policy!r}")
        self.priority = int(priority)
        self.weight = float(weight)
        self.quota = int(quota)
        self.policy = policy

    def as_dict(self) -> dict:
        return {"priority": self.priority, "weight": self.weight,
                "pending_bytes_quota": self.quota, "policy": self.policy}

    def __repr__(self) -> str:
        return (f"QosClass(priority={self.priority}, weight={self.weight}"
                f", quota={self.quota}, policy={self.policy!r})")


# --------------------------------------------------------------------------
# tenant-class registry (static config; reads on the enqueue hot path)
# --------------------------------------------------------------------------

# Plain leaf lock, like the metrics registry's: nothing is acquired under
# it and it never blocks on anything.
_mu = threading.Lock()
_classes: dict[str, QosClass] = {}
_explicit: set[str] = set()          # labels set via the API (these win)
_env_labels: set[str] = set()        # labels installed from the env spec
_env_classes_raw: str | None = None  # last-parsed HVD_QOS_CLASSES value
# per-label resolution cache: get_class rides the per-submission enqueue
# hot path, so steady state must be one env read + one dict hit, not a
# lock + a default-class rebuild. Invalidated on configure/reset and on
# any HVD_QOS_CLASSES change; HVD_QOS_DEFAULT_* knobs are resolved at a
# label's first lookup (static-config contract — docs/qos.md).
_resolved: dict[str, QosClass] = {}


def _parse_spec(label: str, spec: str) -> QosClass:
    """One ``HVD_QOS_CLASSES`` entry body: ``key=value[,key=value...]``
    with keys priority/weight/quota/policy."""
    kw: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"HVD_QOS_CLASSES entry for {label!r}: expected key=value, "
                f"got {item!r}")
        key, _, val = item.partition("=")
        key = key.strip()
        if key == "priority":
            kw["priority"] = int(val)
        elif key == "weight":
            kw["weight"] = float(val)
        elif key == "quota":
            kw["quota"] = int(val)
        elif key == "policy":
            kw["policy"] = val.strip()
        else:
            raise ValueError(
                f"HVD_QOS_CLASSES entry for {label!r}: unknown key {key!r} "
                "(valid: priority, weight, quota, policy)")
    return QosClass(**{**_default_kw(), **kw})


def _default_kw() -> dict:
    return {
        "priority": envs.get_int(envs.QOS_DEFAULT_PRIORITY, 0),
        "weight": envs.get_float(envs.QOS_DEFAULT_WEIGHT,
                                 envs.DEFAULT_QOS_WEIGHT),
        "quota": envs.get_int(envs.QOS_PENDING_QUOTA, 0),
        "policy": (envs.get(envs.QOS_SHED_POLICY, "block")
                   or "block").strip().lower(),
    }


def _sync_env_classes_locked() -> None:
    """Fold ``HVD_QOS_CLASSES`` into the registry (re-parsed when the
    knob's value changes; explicit set_qos/configure_label entries win —
    the API is the more specific configuration). Parsing is
    all-or-nothing: the spec is validated in full BEFORE anything is
    installed or marked parsed, so a malformed entry raises on every
    lookup instead of raising once and then silently running with a
    half-applied config. A changed spec REPLACES the previously
    env-installed entries (stale classes, and labels deleted from the
    spec, are dropped); only explicit API registrations survive it."""
    global _env_classes_raw
    raw = envs.get(envs.QOS_CLASSES)
    if raw == _env_classes_raw:
        return
    parsed: list[tuple[str, QosClass]] = []
    for entry in (raw or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        label, _, spec = entry.partition(":")
        label = label.strip()
        if not label:
            raise ValueError(
                f"HVD_QOS_CLASSES entry {entry!r}: missing tenant label "
                "(grammar: '<tenant>:key=value,...;...' — docs/qos.md)")
        parsed.append((label, _parse_spec(label, spec)))
    _env_classes_raw = raw
    for label in _env_labels - _explicit:
        _classes.pop(label, None)
    _env_labels.clear()
    _resolved.clear()
    for label, cls in parsed:
        if label not in _explicit:
            _classes[label] = cls
            _env_labels.add(label)


def configure_label(label: str, *, priority=None, weight=None,
                    pending_bytes_quota=None, policy=None) -> QosClass:
    """Install/update the class for tenant ``label`` (the string form of
    :func:`tenant_label` — tests and the env parser use this directly;
    users go through :func:`set_qos`). Unspecified fields keep the
    tenant's current value, else the ``HVD_QOS_DEFAULT_*`` defaults."""
    with _mu:
        _sync_env_classes_locked()
        base = _classes.get(label)
        if base is not None:
            kw = {"priority": base.priority, "weight": base.weight,
                  "quota": base.quota, "policy": base.policy}
        else:
            kw = _default_kw()
        if priority is not None:
            kw["priority"] = int(priority)
        if weight is not None:
            kw["weight"] = float(weight)
        if pending_bytes_quota is not None:
            kw["quota"] = int(pending_bytes_quota)
        if policy is not None:
            kw["policy"] = policy
        cls = QosClass(**kw)
        _classes[label] = cls
        _explicit.add(label)
        _env_labels.discard(label)
        _resolved.clear()
        return cls


def set_qos(process_set=None, *, priority=None, weight=None,
            pending_bytes_quota=None, policy=None) -> QosClass:
    """Attach a QoS class to ``process_set`` (None = the global set):
    ``hvd.set_qos(ps, priority=1, weight=4.0,
    pending_bytes_quota=1 << 20, policy="shed")``. Static config by
    contract: in multi-process jobs every member rank must apply the
    identical configuration at the same program point (like every other
    collective-affecting call), and changes apply from the next
    submission."""
    return configure_label(tenant_label(process_set), priority=priority,
                           weight=weight,
                           pending_bytes_quota=pending_bytes_quota,
                           policy=policy)


def get_class(label: str) -> QosClass:
    """The effective class for tenant ``label``: explicit registration,
    else an ``HVD_QOS_CLASSES`` entry, else the env-default class
    (frozen at the label's first lookup)."""
    if envs.get(envs.QOS_CLASSES) == _env_classes_raw:
        cls = _resolved.get(label)  # benign racy read under the GIL
        if cls is not None:
            return cls
    with _mu:
        _sync_env_classes_locked()
        cls = _classes.get(label)
        if cls is None:
            cls = QosClass(**_default_kw())
        _resolved[label] = cls
        return cls


def classes() -> dict:
    """Configured tenant classes (label -> dict), for stats surfaces."""
    with _mu:
        _sync_env_classes_locked()
        return {label: cls.as_dict() for label, cls in
                sorted(_classes.items())}


def reset() -> None:
    """Drop every configured class (tests / teardown)."""
    global _env_classes_raw
    with _mu:
        _classes.clear()
        _explicit.clear()
        _env_labels.clear()
        _resolved.clear()
        _env_classes_raw = None


# --------------------------------------------------------------------------
# the admission gate
# --------------------------------------------------------------------------

class _Rec:
    """One parked batch: the batch itself plus the admission metadata
    frozen at submission time (class changes never reorder already-
    parked work)."""

    __slots__ = ("batch", "tenant", "tier", "weight", "nbytes", "seq",
                 "svc", "names", "t_submit")

    def __init__(self, batch, tenant, cls, nbytes, seq, names, t_submit):
        self.batch = batch
        self.tenant = tenant
        self.tier = cls.priority
        self.weight = cls.weight
        self.nbytes = nbytes
        self.seq = seq
        self.svc = not batch.spec.single
        self.names = names
        self.t_submit = t_submit


class QosGate:
    """Strict-priority + deficit-round-robin admission gate in front of
    the pipelined flush executor.

    All state is guarded by the OWNING scheduler's ``_exec_cv`` (passed
    in), so grant emission into the executor queue is atomic with the
    arbitration decision — two concurrent release points can never
    interleave their grant sequences. Methods suffixed ``_locked``
    assume the condition is held. ``emit(batch)`` is invoked under the
    condition and must enqueue the batch onto the executor FIFO."""

    def __init__(self, cv, emit, on_park=None):
        self._cv = cv
        self._emit = emit
        self._on_park = on_park  # invoked under cv after each park
        self._parked: dict[str, deque] = {}   # tenant -> FIFO of _Rec
        self._order: list[str] = []           # tenant first-arrival order
        self._deficit: dict[str, float] = {}
        self._cursor: dict[int, int] = {}     # per-tier DRR rotation
        self._credited: dict[int, bool] = {}  # cursor tenant credited?
        self._seq = 0
        self._count = 0
        self._svc_count = 0
        # per-tenant parked single-controller bytes: counted by the
        # block-policy quota (they drain via executor demand pulls with
        # no producer action, so a blocked producer cannot deadlock on
        # them — parked NEGOTIATED bytes are excluded: window-bounded,
        # and grantable only at deterministic points the blocked
        # producer would never reach)
        self._sc_bytes: dict[str, float] = {}
        self._valve = 0                       # grants since starve valve
        self._by_entry: dict[int, _Rec] = {}  # id(entry) -> rec
        self._tenant_stats: dict[str, dict] = {}
        self._total_granted_bytes = 0.0
        self._forced = 0
        self._starve_grants = 0
        # deterministic grant record (tenant, seq) — the determinism
        # tests compare it across schedulers fed identical streams
        self.grant_history: deque = deque(maxlen=256)
        self._series: dict[str, dict] = {}    # bound metric handles

    # -- metric plumbing ---------------------------------------------------

    def _tenant_series(self, tenant: str) -> dict:
        s = self._series.get(tenant)
        if s is None:
            labels = {"process_set": tenant}
            s = self._series[tenant] = {
                "wait": _metrics.QOS_ADMISSION_WAIT.bind(labels),
                "granted": _metrics.QOS_GRANTED_BYTES.bind(labels),
                "share": _metrics.QOS_SLOT_SHARE.bind(labels),
            }
        return s

    def _tstats(self, tenant: str) -> dict:
        t = self._tenant_stats.get(tenant)
        if t is None:
            t = self._tenant_stats[tenant] = {
                "granted_batches": 0, "granted_bytes": 0.0}
        return t

    # -- submission (a rank-deterministic flush trigger point) -------------

    def submit(self, batch, tenant: str, cls: QosClass) -> None:
        nbytes = sum(e.nbytes for e in batch.entries)
        names = frozenset(n for e in batch.entries for n in e.names if n)
        with self._cv:
            rec = _Rec(batch, tenant, cls, nbytes, self._seq, names,
                       _inv.monotonic())
            self._seq += 1
            dq = self._parked.get(tenant)
            if dq is None:
                dq = self._parked[tenant] = deque()
                self._order.append(tenant)
            dq.append(rec)
            self._count += 1
            if rec.svc:
                self._svc_count += 1
            else:
                self._sc_bytes[tenant] = (self._sc_bytes.get(tenant, 0.0)
                                          + nbytes)
            for e in batch.entries:
                self._by_entry[id(e)] = rec
            _timeline.record_qos("PARK", tenant)
            if self._on_park is not None:
                # single-controller batches may grant ONLY on executor
                # demand — the executor thread must exist to demand
                self._on_park()
            # deterministic window pump: grant fair-order picks until the
            # negotiated (svc) backlog fits the arbitration window —
            # single-controller batches instead grant on executor demand
            window = max(envs.qos_window(), 0)
            while self._svc_count > window:
                self._grant_locked(self._pick_locked())
            self._cv.notify_all()  # wake the executor for demand pulls

    # -- arbitration -------------------------------------------------------

    def _active_tenants(self, sc_only: bool) -> list[str]:
        return [t for t in self._order
                if self._parked.get(t)
                and not (sc_only and self._parked[t][0].svc)]

    def _pick_locked(self, sc_only: bool = False) -> _Rec | None:
        """The next batch in fair order: the starvation valve's
        oldest-first grant every ``HVD_QOS_STARVE_LIMIT`` grants, else
        strict-priority tiers with deficit-round-robin (byte-weighted)
        inside the top tier. Deterministic: depends only on parked state
        (a pure function of the submission stream) and static config."""
        active = self._active_tenants(sc_only)
        if not active:
            return None
        limit = envs.qos_starve_limit()
        if limit > 0 and self._valve >= limit:
            self._valve = 0
            self._starve_grants += 1
            oldest = min(active, key=lambda t: self._parked[t][0].seq)
            return self._parked[oldest][0]
        top = max(self._parked[t][0].tier for t in active)
        tier = [t for t in active if self._parked[t][0].tier == top]
        quantum = max(envs.qos_quantum_bytes(), 1)
        cur = self._cursor.get(top, 0) % len(tier)
        credited = self._credited.get(top, False)
        # classic DRR: a tenant is credited quantum*weight ONCE on
        # arrival of the rotation cursor, serves while its deficit
        # lasts, then the cursor moves on. Terminates: every full
        # rotation credits each tenant quantum*weight > 0, so some head
        # batch eventually fits.
        while True:
            t = tier[cur]
            head = self._parked[t][0]
            if self._deficit.get(t, 0.0) >= head.nbytes:
                self._cursor[top] = cur
                self._credited[top] = credited
                return head
            if not credited:
                self._deficit[t] = (self._deficit.get(t, 0.0)
                                    + quantum * head.weight)
                credited = True
                continue
            cur = (cur + 1) % len(tier)
            credited = False

    def _grant_locked(self, rec: _Rec | None, forced: bool = False) -> None:
        if rec is None:
            return
        dq = self._parked[rec.tenant]
        assert dq[0] is rec, "QoS grant must serve the tenant's FIFO head"
        dq.popleft()
        self._count -= 1
        if rec.svc:
            self._svc_count -= 1
        else:
            self._sc_bytes[rec.tenant] = max(
                0.0, self._sc_bytes.get(rec.tenant, 0.0) - rec.nbytes)
        # forced grants still consume deficit: observed service counts
        # against the tenant's fair share either way
        self._deficit[rec.tenant] = max(
            0.0, self._deficit.get(rec.tenant, 0.0) - rec.nbytes)
        if not dq:
            # classic DRR: an emptied tenant keeps no residual credit
            self._deficit[rec.tenant] = 0.0
        self._valve += 1
        if forced:
            self._forced += 1
        for e in rec.batch.entries:
            self._by_entry.pop(id(e), None)
        ts = self._tstats(rec.tenant)
        ts["granted_batches"] += 1
        ts["granted_bytes"] += rec.nbytes
        self._total_granted_bytes += rec.nbytes
        series = self._tenant_series(rec.tenant)
        series["granted"].inc(rec.nbytes)
        series["wait"].observe(max(_inv.monotonic() - rec.t_submit, 0.0))
        # only the GRANTING tenant's share gauge updates per grant (an
        # all-tenant refresh would make grant cost O(tenants) inside
        # the executor condition); other tenants' gauges refresh at
        # their own grants and on every stats read (stats_locked)
        if self._total_granted_bytes > 0:
            series["share"].set(
                ts["granted_bytes"] / self._total_granted_bytes)
        self.grant_history.append((rec.tenant, rec.seq))
        # Lockstep decision point: the arbiter's
        # grant order — tenant, per-tenant submission seq, and whether
        # the starvation valve forced it — must be identical rank-wise.
        _conformance.record("qos.py::QosGate._grant_locked", "grant",
                            (rec.tenant, rec.seq, bool(forced)))
        _timeline.record_qos("FORCE" if forced else "GRANT", rec.tenant)
        self._emit(rec.batch)

    # -- demand pull (single-controller batches only) ----------------------

    def demand_pull_locked(self) -> bool:
        """Executor-side work-conserving grant: when the executor FIFO
        runs dry, grant the fair-order pick among parked
        single-controller batches (no negotiation service — no peer
        executor whose issue order could diverge). Returns True when a
        batch was emitted. Negotiated batches are never demand-pulled:
        their grant points must be rank-deterministic."""
        rec = self._pick_locked(sc_only=True)
        if rec is None:
            return False
        self._grant_locked(rec)
        return True

    # -- forced releases (handle observation / drains) ---------------------

    def _release_through_locked(self, rec: _Rec) -> None:
        """Grant ``rec``'s tenant FIFO up to and including ``rec``
        (earlier same-tenant batches must dispatch first: per-signature
        FIFO within a tenant)."""
        dq = self._parked.get(rec.tenant)
        while dq:
            head = dq[0]
            self._grant_locked(head, forced=True)
            if head is rec:
                return

    def release_entry(self, entry) -> None:
        """Handle-observation release (synchronize / first poll) for
        NEGOTIATED batches: if the entry's batch is parked, grant it
        now — a rank-deterministic program point, so every rank's gate
        jumps identically. Single-controller batches deliberately do
        NOT force-release: the executor's demand pull already
        guarantees their progress in tier-first fair order, and a
        forced jump here would let a bulk tenant's synchronize dump its
        parked backlog into the executor FIFO ahead of a latency
        tenant's next request (measured as ~10x p99 spikes in
        the JAX package's serving benchmark before this rule)."""
        with self._cv:
            rec = self._by_entry.get(id(entry))
            if rec is not None and rec.svc:
                self._release_through_locked(rec)

    def release_names(self, names) -> None:
        """Name-reuse guard support: grant every parked batch holding
        one of ``names`` (the enqueue-side clash wait would otherwise
        park forever behind the gate)."""
        with self._cv:
            self.release_names_locked(names)

    def release_names_locked(self, names) -> None:
        """Locked body of :meth:`release_names` — also called from
        ``_wait_names_clear``'s wait loop under the shared condition:
        the clashing batch may only PARK after the waiter's first
        release attempt (the drain registers its names before the
        negotiate-submit round trip that precedes the park), so the
        waiter must re-attempt the release on every wakeup or that
        window would park it forever."""
        pending = set(names)
        while pending:
            hit = None
            for tenant in self._order:
                for rec in self._parked.get(tenant, ()):
                    if not pending.isdisjoint(rec.names):
                        if hit is None or rec.seq < hit.seq:
                            hit = rec
                        break
            if hit is None:
                return
            pending.difference_update(hit.names)
            self._release_through_locked(hit)

    def release_all(self) -> None:
        """Drain the gate in fair order (flush_all / barrier / shutdown:
        callers need everything dispatched on return)."""
        with self._cv:
            self.release_all_locked()

    def release_all_locked(self) -> None:
        while self._count:
            self._grant_locked(self._pick_locked())

    def drain_locked(self) -> list:
        """Abort path: pop every parked batch WITHOUT emitting (the
        world the batches were negotiated against is gone); the caller
        fails their entries. Resets arbitration state."""
        batches = []
        for tenant in self._order:
            dq = self._parked.get(tenant)
            while dq:
                rec = dq.popleft()
                for e in rec.batch.entries:
                    self._by_entry.pop(id(e), None)
                batches.append(rec.batch)
        self._count = 0
        self._svc_count = 0
        self._sc_bytes.clear()
        self._deficit.clear()
        return batches

    # -- introspection -----------------------------------------------------

    def parked_depth_locked(self) -> int:
        return self._count

    def sc_parked_bytes_locked(self, tenant: str) -> float:
        """Parked single-controller bytes for ``tenant`` (the
        block-quota component that drains on executor demand)."""
        return self._sc_bytes.get(tenant, 0.0)

    def stats_locked(self) -> dict:
        # union of granted AND parked tenants: a never-granted tenant
        # parked behind higher tiers (the starvation condition this
        # surface exists to expose) must still show its parked depth
        names = set(self._tenant_stats)
        names.update(t for t, dq in self._parked.items() if dq)
        tenants = {}
        for tenant in sorted(names):
            st = self._tenant_stats.get(
                tenant, {"granted_batches": 0, "granted_bytes": 0.0})
            share = (st["granted_bytes"] / self._total_granted_bytes
                     if self._total_granted_bytes else 0.0)
            if st["granted_bytes"]:
                # stats reads re-true every tenant's share gauge (the
                # per-grant path only updates the granting tenant's)
                self._tenant_series(tenant)["share"].set(share)
            tenants[tenant] = {
                "granted_batches": st["granted_batches"],
                "granted_bytes": st["granted_bytes"],
                "share": share,
                "parked": len(self._parked.get(tenant, ())),
            }
        return {
            "parked": self._count,
            "parked_svc": self._svc_count,
            "forced_grants": self._forced,
            "starve_grants": self._starve_grants,
            "granted_bytes_total": self._total_granted_bytes,
            "tenants": tenants,
        }


def qos_stats() -> dict:
    """The ``hvd.qos_stats()`` surface: static config (knobs + tenant
    classes) plus the calling world's scheduler-side admission counters
    (``fusion_stats()["qos"]``)."""
    from .ops import fusion_cycle as _fc
    return {
        "enabled": enabled(),
        "window": envs.qos_window(),
        "quantum_bytes": envs.qos_quantum_bytes(),
        "starve_limit": envs.qos_starve_limit(),
        "classes": classes(),
        **_fc.scheduler().stats().get("qos", {}),
    }
