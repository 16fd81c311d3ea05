"""Cycle-driven cross-call fusion of eager async collectives, with its
pipelined flush executor (port of ``horovod_tpu/ops/fusion_cycle.py``).

The reference's background cycle coalesces independently submitted small
tensors into fusion buffers bounded by ``HOROVOD_FUSION_THRESHOLD`` and
flushes every ``HOROVOD_CYCLE_TIME`` (``operations.cc:385-806``). Here
``allreduce_async`` / ``grouped_allreduce_async`` / ``broadcast_async`` /
``allgather_async`` / ``sparse_allreduce_async`` and the optimizer's
gradient buckets enqueue into per-signature pending queues (keyed by op
kind, process set, reduce op, scales, hierarchical flag and wire dtype:
everything in one queue may fuse into one grouped collective). A queue
flushes when

* its pending bytes reach ``HVD_FUSION_THRESHOLD`` (trigger
  ``threshold``),
* ``HVD_CYCLE_TIME`` elapses on its oldest entry, or
  ``HVD_PENDING_CYCLE_TIME`` while work is in flight (``cycle``),
* the bytes pending in all queues exceed ``HVD_FUSION_MAX_PENDING``
  (``backpressure``),
* a handle is observed (``poll``, ``synchronize``) or the optimizer
  issues a bucket (``bucket``),
* a synchronization point drains everything (``barrier``, ``join``,
  ``shutdown``), or a user name repeats in a negotiated queue
  (``name-reuse``).

A flush is one grouped collective through the dispatch plan cache
(``ops/dispatch_cache.py``, source ``flush``).

**Determinism.** Flush composition must be the same on every rank. The
JAX package's single controller holds every rank's queue, so any trigger
is consistent there. A process here is one rank, so a queue over a set of
more than one rank never flushes from the timer (whose firing differs
between processes); its flushes happen at points of the program, which
are the same on every rank. Under a negotiation service
(``engine_service.py``) each entry's names are drawn at submission and
its requests go to the service at enqueue, a point of the program on
every rank (the service's cycle batches them into rounds; the JAX
package submits them at the flush instead, but a process a rank must
let ranks observe their handles in different orders, as the reference
does). A flush hands the entries to the executor, which issues each in
its submission-time composition (what a joined rank rebuilds from the
plan: ``collectives._execute_joined_zeros``), in the service's agreed
order. A sparse entry under a service issues at once.

**The pipelined executor** (``HVD_MAX_INFLIGHT_FLUSHES``, default 2): a
trigger only drains a queue and hands the batch to one dispatch thread,
which issues batches in submission order with a bounded window of
device-incomplete flushes. On the card the executor runs on the device of
``init()`` and issues on a stream of its own: each entry records an event
on its submitter's current stream at enqueue, the executor's stream waits
for it, and a flush is device-incomplete while the event recorded after
its collectives has not completed. Admission past the window waits on the
oldest flush's event. Wire buffers past ``HVD_PIPELINE_THRESHOLD`` issue
as ``HVD_PIPELINE_CHUNKS`` chunk collectives. ``HVD_MAX_INFLIGHT_FLUSHES``
0 or 1 executes a flush on the thread that triggered it. Issue order on a
communicator equals submission order: a collective issued outside the
cycle first waits until every batch submitted before it has been issued
(``ops/program_issue.ordered``).

**QoS** (``HVD_QOS=1``, ``qos.py``): batches pass a strict-priority,
deficit-round-robin admission gate on their way to the executor.

**Step capture** (``HVD_STEP_CAPTURE=1``, ``ops/step_capture.py``): the
scheduler's :class:`~.step_capture.CaptureState` records a marked step's
flushes and replays later steps as one CUDA Graph.

:func:`stats` (``hvd.fusion_stats()``) reports the JAX package's dict.
The timeline gains ``QUEUE_ENQUEUE``, ``CYCLE_FLUSH`` and
``INFLIGHT_DEPTH`` instants and ``PIPELINE_SLOT_WAIT`` ranges.
``HVD_CYCLE_TIME=0`` turns the scheduler off (immediate dispatch).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque

import torch

from .. import conformance as _conformance
from .. import metrics as _metrics
from .. import qos as _qos
from .. import timeline as _timeline
from ..utils import envs
from ..utils import faults as _faults
from ..utils import invariants as _inv
from ..utils import logging as hvd_logging
from . import dispatch_cache as _dispatch_cache
from . import step_capture as _step_capture

FLUSH_TRIGGERS = ("threshold", "cycle", "synchronize", "poll", "barrier",
                  "join", "shutdown", "backpressure", "name-reuse",
                  "bucket")

# after a dispatch the scheduler flushes at the PENDING_CYCLE_TIME pace for
# one cycle window (_age_limit_s)
_INFLIGHT_WINDOW_CYCLES = 1.0

_PENDING_BYTES_G = _metrics.FUSION_PENDING_BYTES.bind()
_INFLIGHT_DEPTH_G = _metrics.PIPELINE_INFLIGHT_DEPTH.bind()
_tenant_series: dict = {}


def _tenant_metrics(tenant: str) -> dict:
    t = _tenant_series.get(tenant)
    if t is None:
        t = _tenant_series[tenant] = {
            "enqueued": _metrics.FUSION_ENQUEUED_TENSORS.bind(
                {"process_set": tenant}),
            "tensors": _metrics.FUSION_FLUSHED_TENSORS.bind(
                {"process_set": tenant}),
            "bytes": _metrics.FUSION_FLUSHED_BYTES.bind(
                {"process_set": tenant}),
            "flushes": {},  # trigger -> bound counter
        }
    return t


def _flush_counter(tm: dict, tenant: str, trigger: str):
    c = tm["flushes"].get(trigger)
    if c is None:
        c = tm["flushes"][trigger] = _metrics.FUSION_FLUSHES.bind(
            {"process_set": tenant, "trigger": trigger})
    return c


def _qos_tenant_counter(tenant: str, kind: str):
    tm = _tenant_metrics(tenant)
    c = tm.get("qos_" + kind)
    if c is None:
        inst = (_metrics.QOS_SHED if kind == "shed"
                else _metrics.QOS_QUOTA_BLOCKS)
        c = tm["qos_" + kind] = inst.bind({"process_set": tenant})
    return c


def enabled() -> bool:
    """The scheduler queues async ops while ``HVD_CYCLE_TIME`` > 0."""
    return envs.cycle_time_ms() > 0.0


def max_pending_bytes() -> int:
    """Backpressure cap on the bytes queued in all queues
    (``HVD_FUSION_MAX_PENDING``; default 4x the fusion threshold)."""
    return envs.get_int(envs.FUSION_MAX_PENDING,
                        4 * envs.fusion_threshold_bytes())


def pending_cycle_time_ms() -> float:
    """Flush pace while work is in flight (``HVD_PENDING_CYCLE_TIME``;
    default half the cycle time, at most 2 ms)."""
    cycle = envs.cycle_time_ms()
    return envs.get_float(envs.PENDING_CYCLE_TIME, min(cycle / 2.0, 2.0))


def dispatch_key(pset):
    """A process set's identity in queue and plan keys (the JAX package's
    ``ProcessSet.dispatch_key``): its registered id, else its ranks."""
    if pset.process_set_id is not None:
        return pset.process_set_id
    return tuple(pset.ranks)


_sync_streams: dict = {}


def sync_stream(device: torch.device):
    """The stream the executor issues ``device``'s flushes on (and a
    captured step replays on)."""
    stream = _sync_streams.get(device)
    if stream is None:
        stream = _sync_streams[device] = torch.cuda.Stream(device)
    return stream


class _QueueSpec:
    """Per-queue dispatch parameters, fixed at the first enqueue. ``kind``
    is allreduce/broadcast/allgather/sparse; ``single``: the set has one
    rank and no service, so no peer's flushes could differ from this
    process's (the timer may flush it, and QoS may grant it on
    demand)."""

    __slots__ = ("kind", "pset", "op", "pre", "post", "root_rank",
                 "compression", "svc", "single")

    def __init__(self, kind, pset, op=None, pre=1.0, post=1.0,
                 root_rank=-1, compression=None, svc=None):
        self.kind = kind
        self.pset = pset
        self.op = op
        self.pre = pre
        self.post = post
        self.root_rank = root_rank
        self.compression = compression
        self.svc = svc
        self.single = svc is None and pset.size() == 1


class _Part:
    """Entry results: items ``lo:hi`` of a unit handle's result list
    (``collectives.Handle``, shared by the entries of one wire unit)."""

    __slots__ = ("handle", "lo", "hi")

    def __init__(self, handle, lo: int, hi: int):
        self.handle, self.lo, self.hi = handle, lo, hi

    def get(self) -> list:
        return list(self.handle.synchronize()[self.lo:self.hi])

    def wait(self) -> None:
        self.handle.wait()

    def poll(self) -> bool:
        return self.handle.poll()


class _Entry:
    """One queued ``*_async`` submission: a single tensor or an atomic
    group. ``requests`` are its negotiation requests (names drawn at
    submission); ``run`` the executor of an opaque (sparse) entry;
    ``ready`` the CUDA event recorded on the submitter's stream."""

    __slots__ = ("tensors", "count", "grouped", "nbytes", "names",
                 "requests", "run", "queue_key", "label", "event",
                 "results", "error", "sigs", "captured", "qos_tenant",
                 "qos_acked", "qos_inflight", "qos_epoch", "ready",
                 "ticket")

    def __init__(self, tensors, grouped, nbytes, names, requests=(),
                 run=None, label=""):
        self.tensors = tensors
        self.count = len(tensors)
        self.grouped = grouped
        self.nbytes = nbytes
        self.names = tuple(names)
        self.requests = tuple(requests)
        self.run = run
        self.queue_key = None
        self.label = label or (names[0] if names else "queued")
        self.event = _inv.make_event("fusion_cycle.entry")
        self.results: _Part | None = None
        self.error = None
        self.sigs = None  # plan signatures; None: never capturable
        self.captured = False  # held by a step-capture replay
        self.qos_tenant = None
        self.qos_acked = False
        self.qos_inflight = False
        self.qos_epoch = 0
        self.ticket = None  # the service's queued item (engine_service)
        self.ready = None
        devs = [t for t in tensors if isinstance(t, torch.Tensor)
                and t.is_cuda]
        if devs:
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(devs[0].device))

    @property
    def done(self) -> bool:
        return self.event.is_set()


class _Queue:
    __slots__ = ("spec", "entries", "nbytes", "oldest_t", "names")

    def __init__(self, spec):
        self.spec = spec
        self.entries: list[_Entry] = []
        self.nbytes = 0
        self.oldest_t = 0.0
        self.names: set = set()


class _Batch:
    """One drained flush for the executor: spec, entries in submission
    order, trigger."""

    __slots__ = ("spec", "entries", "trigger")

    def __init__(self, spec, entries, trigger):
        self.spec = spec
        self.entries = entries
        self.trigger = trigger


class _EventMark:
    """A flush's device-completion marker on the card: an event recorded
    on the executor's stream after it waited for the flush's
    collectives."""

    __slots__ = ("event",)

    def __init__(self, event):
        self.event = event

    def is_completed(self) -> bool:
        return self.event.query()

    def wait(self) -> None:
        self.event.synchronize()


class FusionScheduler:
    """The pending queues, the cycle timer thread, the pipelined executor
    and the flush statistics. One a process (:func:`scheduler`); tests
    make fresh ones."""

    def __init__(self):
        self._mu = _inv.make_lock("fusion_cycle.scheduler.mu")
        self._queues: "OrderedDict[tuple, _Queue]" = OrderedDict()
        self._pending_tensors = 0
        self._pending_bytes = 0
        self._wake = _inv.make_event("fusion_cycle.scheduler.wake")
        self._stop = _inv.make_event("fusion_cycle.scheduler.stop")
        self._thread: threading.Thread | None = None
        self._inflight_until = 0.0
        self._stats = self._zero_stats()
        # (trigger, queue key, entry names) per flush: the composition
        # record the determinism tests compare
        self.flush_history: deque = deque(maxlen=64)
        self._exec_cv = _inv.make_condition("fusion_cycle.scheduler.exec_cv")
        self._exec_q: "deque[_Batch]" = deque()
        self._exec_busy = False
        self._exec_stop = False
        self._exec_thread: threading.Thread | None = None
        self._exec_inflight: deque = deque()  # completion markers a flush
        self._exec_names: set = set()  # svc names submitted, not yet done
        self._pstats = self._zero_pstats()
        # batches handed to the executor, and those it has issued: a
        # collective outside the cycle waits for the second to reach the
        # first (wait_issued); never reset
        self._submitted_seq = 0
        self._issued_seq = 0
        self._qos_gate = None
        self._qos_unacked: dict[str, float] = {}
        self._qos_inflight: dict[str, float] = {}
        self._qos_epoch = 0
        self._qos_stats = {"shed": {}, "quota_blocks": 0}
        self.capture = _step_capture.CaptureState(self)

    @staticmethod
    def _zero_stats() -> dict:
        return {"enqueued_tensors": 0, "enqueued_bytes": 0,
                "flushed_tensors": 0, "flushed_bytes": 0, "dispatches": 0,
                "wire_programs": 0,
                "flushes": {t: 0 for t in FLUSH_TRIGGERS}}

    @staticmethod
    def _zero_pstats() -> dict:
        return {"submitted": 0, "executed": 0, "overlapped": 0,
                "depth_sum": 0, "inflight_peak": 0, "slot_waits": 0,
                "device_wait_ms": 0.0}

    # -- enqueue -----------------------------------------------------------

    def enqueue(self, key: tuple, spec: _QueueSpec, entry: _Entry) -> None:
        # a flush execution must never re-enter the scheduler
        _inv.assert_outside("fusion-cycle-flush", "FusionScheduler.enqueue")
        entry.queue_key = key
        if self.capture.offer(key, spec, entry):
            return  # held for the captured step
        if _qos.enabled():
            tenant = _qos.tenant_label(spec.pset)
            entry.qos_tenant = tenant
            if not self._qos_admit(entry, tenant, _qos.get_class(tenant)):
                return  # shed: the handle raises QosAdmissionError
        if entry.requests:
            # a user name repeated in a negotiated queue: flush the queue
            # first so the two negotiations stay sequential
            with self._mu:
                q = self._queues.get(key)
                clash = q is not None and not q.names.isdisjoint(entry.names)
            with self._exec_cv:
                exec_clash = not self._exec_names.isdisjoint(entry.names)
            if clash:
                self.flush_queue(key, "name-reuse")
            if clash or exec_clash:
                gate = self._qos_gate
                if gate is not None:
                    gate.release_names(entry.names)
                self._wait_names_clear(entry.names)
        if spec.svc is not None:
            entry.ticket = self._submit_entry(spec, entry)
        with self._mu:
            _inv.assert_holding(self._mu, "pending-queue mutation (enqueue)")
            q = self._queues.get(key)
            if q is None:
                q = _Queue(spec)
                q.oldest_t = _inv.monotonic()
                self._queues[key] = q
            q.entries.append(entry)
            q.names.update(entry.names)
            q.nbytes += entry.nbytes
            self._pending_tensors += entry.count
            self._pending_bytes += entry.nbytes
            self._stats["enqueued_tensors"] += entry.count
            self._stats["enqueued_bytes"] += entry.nbytes
            pending_bytes = self._pending_bytes
            over_threshold = q.nbytes >= envs.fusion_threshold_bytes()
            over_pending = self._pending_bytes >= max_pending_bytes()
            if spec.single:
                self._ensure_thread_locked()
        _tenant_metrics(_qos.tenant_label(spec.pset))["enqueued"].inc(
            entry.count)
        _PENDING_BYTES_G.set(pending_bytes)
        for name in entry.names:
            _timeline.record_queue_enqueue(name or entry.label)
        self._wake.set()
        if over_pending:
            if _qos.enabled() and entry.qos_tenant is not None and \
                    _qos.get_class(entry.qos_tenant).quota > 0:
                # a quota'd tenant drains back under the cap, lowest tier
                # first, without stalling on the whole backlog
                self._drain_queues("backpressure",
                                   until_under=max_pending_bytes() // 2)
            else:
                self.flush_all("backpressure")
        elif over_threshold:
            self.flush_queue(key, "threshold")

    # -- QoS admission (qos.py) --------------------------------------------

    def _qos_admit(self, entry: _Entry, tenant: str, cls) -> bool:
        """The tenant's pending-bytes quota at enqueue: ``shed`` fails the
        submission when its unacknowledged bytes (enqueue to synchronize
        return, both points of the program) would pass the quota;
        ``block`` waits for granted-but-unsettled bytes (and parked
        single-controller bytes) to drain, which the executor does with no
        action of this producer. Returns False when shed."""
        from ..exceptions import QosAdmissionError
        if cls.policy == "shed" and cls.quota > 0:
            with self._exec_cv:
                pending = self._qos_unacked.get(tenant, 0.0)
                if pending + entry.nbytes <= cls.quota:
                    self._qos_unacked[tenant] = pending + entry.nbytes
                    entry.qos_epoch = self._qos_epoch
                    return True
                shed = self._qos_stats["shed"]
                shed[tenant] = shed.get(tenant, 0) + 1
            entry.qos_acked = True  # never charged
            entry.error = QosAdmissionError(tenant, entry.nbytes,
                                            int(pending), cls.quota)
            entry.tensors = ()
            entry.run = None
            entry.event.set()
            _qos_tenant_counter(tenant, "shed").inc()
            _timeline.record_qos("SHED", tenant)
            return False
        blocked = False
        with self._exec_cv:
            if cls.policy == "block" and cls.quota > 0:
                while True:
                    pending = self._qos_inflight.get(tenant, 0.0)
                    if self._qos_gate is not None:
                        pending += self._qos_gate.sc_parked_bytes_locked(
                            tenant)
                    # an entry larger than the quota admits once the
                    # tenant is fully drained
                    if (pending <= 0.0
                            or pending + entry.nbytes <= cls.quota):
                        break
                    if not blocked:
                        blocked = True
                        self._qos_stats["quota_blocks"] += 1
                    self._exec_cv.wait()
            self._qos_unacked[tenant] = (
                self._qos_unacked.get(tenant, 0.0) + entry.nbytes)
            entry.qos_epoch = self._qos_epoch
        if blocked:
            _qos_tenant_counter(tenant, "blocks").inc()
            _timeline.record_qos("BLOCK", tenant)
        return True

    def _qos_ack(self, entry: _Entry) -> None:
        """Release the entry's unacknowledged bytes at its synchronize
        return (once; an entry charged before an abort releases
        nothing)."""
        if entry.qos_tenant is None:
            return
        with self._exec_cv:
            if entry.qos_acked:
                return
            entry.qos_acked = True
            if entry.qos_epoch != self._qos_epoch:
                return
            t = entry.qos_tenant
            self._qos_unacked[t] = max(
                0.0, self._qos_unacked.get(t, 0.0) - entry.nbytes)

    def _qos_settle(self, entries) -> None:
        """Release granted-but-unsettled bytes once entries settle."""
        charged = [e for e in entries if e.qos_inflight]
        if not charged:
            return
        with self._exec_cv:
            for e in charged:
                e.qos_inflight = False
                if e.qos_epoch != self._qos_epoch:
                    continue
                t = e.qos_tenant
                self._qos_inflight[t] = max(
                    0.0, self._qos_inflight.get(t, 0.0) - e.nbytes)
            self._exec_cv.notify_all()

    # -- flushing ----------------------------------------------------------

    def flush_queue(self, key: tuple, trigger: str) -> None:
        """Flush one queue (no-op when it is already drained). With the
        pipelined executor this drains the queue, records the flush's
        composition and submits the batch; ``HVD_MAX_INFLIGHT_FLUSHES``
        <= 1 executes it here."""
        pipelined = envs.pipeline_enabled()
        with self._mu:
            _inv.assert_holding(self._mu, "pending-queue mutation (drain)")
            q = self._queues.pop(key, None)
            if q is None or not q.entries:
                return
            entries = q.entries
            self._pending_tensors -= sum(e.count for e in entries)
            self._pending_bytes -= q.nbytes
            self._stats["flushes"][trigger] += 1
            self._stats["flushed_tensors"] += sum(e.count for e in entries)
            self._stats["flushed_bytes"] += q.nbytes
            names = tuple(n for e in entries for n in e.names)
            self.flush_history.append((trigger, key, names))
            # lockstep decision point: what drains must be the same on
            # every rank (when it drains is not hashed). Under a service
            # an entry is its own wire unit, issued in the service's
            # agreed order, so the flush decides nothing there
            if q.spec.svc is None:
                _conformance.record(
                    "ops/fusion_cycle.py::FusionScheduler.flush_queue",
                    "flush", (q.spec.kind, names))
            self._inflight_until = _inv.monotonic() + (
                _INFLIGHT_WINDOW_CYCLES * envs.cycle_time_ms() / 1e3)
            if pipelined:
                # svc names join the executor's guard set in the section
                # that removes them from q.names: a reused name never sees
                # the window between the drain and the submission
                svc_names = {n for e in entries if e.requests
                             for n in e.names}
                if svc_names:
                    with self._exec_cv:
                        self._exec_names.update(svc_names)
            pending_bytes = self._pending_bytes
        tenant = _qos.tenant_label(q.spec.pset)
        tm = _tenant_metrics(tenant)
        _flush_counter(tm, tenant, trigger).inc()
        tm["tensors"].inc(sum(e.count for e in entries))
        tm["bytes"].inc(q.nbytes)
        _PENDING_BYTES_G.set(pending_bytes)
        _timeline.record_cycle_flush(trigger)
        self.capture.note_flush(q.spec, entries, trigger)
        if not pipelined:
            self._execute(q.spec, entries)
            return
        self._submit(_Batch(q.spec, entries, trigger))

    def _submit_entry(self, spec: _QueueSpec, entry: _Entry):
        """Queue one entry's requests with the service, with the issue of
        its submission-time composition (run by ``run_until`` in the
        agreed order, from whichever thread gets there first)."""
        from . import collectives as _coll
        tensors, label = list(entry.tensors), entry.label

        def issue(responses):
            from . import program_issue
            with _dispatch_cache.dispatch_source("flush"), \
                    program_issue.ordered():
                if spec.kind == "allreduce":
                    return _coll._run_queued_allreduce(tensors, spec, label)
                if spec.kind == "broadcast":
                    return _coll._run_queued_broadcast(tensors, spec)
                return _coll._allgather_issue(
                    tensors[0], spec.pset, responses).then(lambda r: [r])

        return spec.svc.submit(list(entry.requests), issue)

    def flush_entry(self, entry: _Entry, trigger: str) -> None:
        if entry.done or entry.queue_key is None:
            return
        if self.capture.intercept_flush(entry, trigger):
            return
        self.flush_queue(entry.queue_key, trigger)
        gate = self._qos_gate
        if gate is not None:
            gate.release_entry(entry)

    def _drain_queues(self, trigger: str, until_under: int | None = None
                      ) -> None:
        """Drain pending queues in first-enqueue order (with QoS, highest
        tier first; a bounded drain evicts the lowest tier first), until
        ``until_under`` bytes remain pending when given."""
        qos_on = _qos.enabled()
        bounded = until_under is not None
        while True:
            with self._mu:
                if bounded and self._pending_bytes <= until_under:
                    return
                key = None
                if qos_on:
                    best = None
                    for i, (k, q) in enumerate(self._queues.items()):
                        tier = _qos.get_class(
                            _qos.tenant_label(q.spec.pset)).priority
                        rank_key = (tier if bounded else -tier, i)
                        if best is None or rank_key < best:
                            best, key = rank_key, k
                else:
                    key = next(iter(self._queues), None)
            if key is None:
                return
            self.flush_queue(key, trigger)

    def flush_all(self, trigger: str) -> None:
        """Drain every queue, release the QoS gate and wait until every
        batch has been issued (barrier / join / shutdown / backpressure)."""
        self._drain_queues(trigger)
        self.capture.flush_pending(trigger)
        gate = self._qos_gate
        if gate is not None:
            gate.release_all()
        self.quiesce()

    def wait_result(self, entry: _Entry) -> list:
        """Synchronize path: flush the entry's queue if it is still
        pending, wait for its issue and its collective, re-raise a
        failure."""
        self.wait_issued_entry(entry)
        return entry.results.get()

    def wait_issued_entry(self, entry: _Entry) -> None:
        """:meth:`wait_result` up to the entry's issue: flush its queue if
        it is still pending, wait until it was issued, re-raise a
        failure."""
        self.flush_entry(entry, "synchronize")
        entry.event.wait()
        self._qos_ack(entry)
        if entry.error is not None:
            raise entry.error

    def poll_entry(self, entry: _Entry) -> bool:
        """Poll path: an unflushed entry first triggers its own flush;
        True once it was issued and its collective finished (or it
        failed)."""
        self.flush_entry(entry, "poll")
        if not entry.done:
            return False
        return entry.error is not None or entry.results.poll()

    # -- pipelined flush executor ------------------------------------------

    def _submit(self, batch: _Batch) -> None:
        if _qos.enabled():
            with self._exec_cv:
                if self._qos_gate is None:
                    self._qos_gate = _qos.QosGate(
                        self._exec_cv, self._emit_batch_locked,
                        on_park=self._ensure_exec_thread_locked)
                gate = self._qos_gate
            tenant = _qos.tenant_label(batch.spec.pset)
            gate.submit(batch, tenant, _qos.get_class(tenant))
            return
        with self._exec_cv:
            self._emit_batch_locked(batch)

    def _ensure_exec_thread_locked(self) -> None:
        if self._exec_thread is None or not self._exec_thread.is_alive():
            self._exec_stop = False
            self._exec_thread = _inv.spawn_thread(
                self._exec_loop, name="hvd-flush-pipeline")

    def _emit_batch_locked(self, batch: _Batch) -> None:
        """Append a batch to the executor FIFO (caller holds
        ``_exec_cv``): the admission point, where QoS granted bytes are
        charged."""
        for e in batch.entries:
            if e.qos_tenant is not None:
                e.qos_inflight = True
                self._qos_inflight[e.qos_tenant] = (
                    self._qos_inflight.get(e.qos_tenant, 0.0) + e.nbytes)
        self._exec_q.append(batch)
        self._pstats["submitted"] += 1
        self._submitted_seq += 1
        self._ensure_exec_thread_locked()
        self._exec_cv.notify_all()

    def _exec_loop(self) -> None:
        """The dispatch thread: one batch at a time, in submission order,
        on the device of ``init()`` (a new thread's current device is
        0)."""
        from .. import runtime
        if runtime.is_initialized() and runtime.device().type == "cuda":
            torch.cuda.set_device(runtime.device())
        while True:
            with self._exec_cv:
                while not self._exec_q:
                    if self._exec_stop:
                        return
                    if (self._qos_gate is not None
                            and self._qos_gate.demand_pull_locked()):
                        continue
                    self._exec_cv.wait()
                batch = self._exec_q.popleft()
                self._exec_busy = True
            try:
                try:
                    self._admit_slot()
                except BaseException:
                    # a failed earlier flush surfaces at its own handles
                    self._exec_inflight.clear()
                try:
                    _faults.inject("exec.delay")
                    self._execute(batch.spec, batch.entries)
                except BaseException:
                    hvd_logging.exception("pipelined flush failed")
                try:
                    self._track_inflight(batch.entries)
                except BaseException:
                    hvd_logging.exception("in-flight tracking failed")
            finally:
                with self._exec_cv:
                    self._exec_busy = False
                    self._pstats["executed"] += 1
                    self._issued_seq += 1
                    for e in batch.entries:
                        if e.requests:
                            self._exec_names.difference_update(e.names)
                    self._exec_cv.notify_all()

    def _admit_slot(self) -> None:
        """Bound the window to ``HVD_MAX_INFLIGHT_FLUSHES`` issued but
        device-incomplete flushes: past it, wait on the oldest flush's
        completion marker (its CUDA event on the card, never a device-wide
        synchronize)."""
        _inv.assert_thread(self._exec_thread,
                           "in-flight window admission (_admit_slot)")
        slots = max(envs.max_inflight_flushes(), 1)

        def _done(marks) -> bool:
            return all(m.is_completed() for m in marks)

        depth = sum(1 for marks in self._exec_inflight if not _done(marks))
        while self._exec_inflight and _done(self._exec_inflight[0]):
            self._exec_inflight.popleft()
        waited = False
        wait_s = 0.0
        while len(self._exec_inflight) >= slots:
            marks = self._exec_inflight.popleft()
            waited = True
            t0 = _inv.monotonic()
            with _timeline.pipeline_stage("SLOT_WAIT"):
                for m in marks:
                    m.wait()
            wait_s += _inv.monotonic() - t0
        live = sum(1 for marks in self._exec_inflight if not _done(marks))
        window_depth = len(self._exec_inflight)
        with self._exec_cv:
            self._pstats["depth_sum"] += window_depth
            if live > 0:
                self._pstats["overlapped"] += 1
            if depth > self._pstats["inflight_peak"]:
                self._pstats["inflight_peak"] = depth
            if waited:
                self._pstats["slot_waits"] += 1
                self._pstats["device_wait_ms"] += wait_s * 1e3
        _INFLIGHT_DEPTH_G.set(depth)
        _timeline.record_inflight_depth(depth)

    def _track_inflight(self, entries: list[_Entry]) -> None:
        """Note the flush's completion markers in the window: its
        collectives' works on the host; on the card an event the
        executor's stream records after waiting for them."""
        _inv.assert_thread(self._exec_thread,
                           "in-flight window tracking (_track_inflight)")
        handles = {id(e.results.handle): e.results.handle for e in entries
                   if e.results is not None and e.error is None}
        works = [w for h in handles.values() for w in h.pending_works()]
        if not works:
            return
        cuda = [e.ready for e in entries if e.ready is not None]
        if cuda:
            stream = sync_stream(torch.device("cuda",
                                              torch.cuda.current_device()))
            with torch.cuda.stream(stream):
                for w in works:
                    w.wait()  # the stream waits; the host does not
                ev = torch.cuda.Event()
                ev.record(stream)
            self._exec_inflight.append([_EventMark(ev)])
        else:
            self._exec_inflight.append(works)

    def quiesce(self) -> None:
        """Block until every submitted batch has been issued. No-op on the
        executor thread."""
        if threading.current_thread() is self._exec_thread:
            return
        with self._exec_cv:
            while self._exec_q or self._exec_busy:
                self._exec_cv.wait()

    def wait_issued(self) -> None:
        """Block until every batch submitted so far has been issued (a
        collective issued outside the cycle: ``program_issue.ordered``).
        No-op on the executor thread."""
        if threading.current_thread() is self._exec_thread:
            return
        with self._exec_cv:
            target = self._submitted_seq
            while self._issued_seq < target:
                self._exec_cv.wait()

    def _wait_names_clear(self, names) -> None:
        """Block until none of ``names`` is in an in-flight negotiated
        flush (the name-reuse guard)."""
        if threading.current_thread() is self._exec_thread:
            return
        names = set(names)
        with self._exec_cv:
            while not self._exec_names.isdisjoint(names):
                if self._qos_gate is not None:
                    self._qos_gate.release_names_locked(names)
                    if self._exec_names.isdisjoint(names):
                        break
                self._exec_cv.wait()

    # -- execution ---------------------------------------------------------

    def _fail_entries(self, entries: list[_Entry], exc) -> None:
        failed = []
        for e in entries:
            if not e.done:
                e.error = exc
                e.tensors = ()
                e.run = None
                e.event.set()
                failed.append(e)
        self._qos_settle(failed)

    def _execute(self, spec: _QueueSpec, entries: list[_Entry]) -> None:
        with _inv.section("fusion-cycle-flush"), \
                _timeline.pipeline_stage("ISSUE"), \
                _dispatch_cache.dispatch_source("flush"):
            cuda = [e.ready for e in entries if e.ready is not None]
            if not cuda:
                self._execute_inner(spec, entries)
                return
            # the executor's stream waits for each submitter's stream at
            # its enqueue, and the inputs stay alive for it
            stream = sync_stream(torch.device("cuda",
                                              torch.cuda.current_device()))
            for ev in cuda:
                stream.wait_event(ev)
            for e in entries:
                for t in e.tensors:
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        t.record_stream(stream)
            with torch.cuda.stream(stream):
                self._execute_inner(spec, entries)

    def _execute_inner(self, spec: _QueueSpec,
                       entries: list[_Entry]) -> None:
        from . import program_issue
        try:
            _faults.inject("exec.dispatch")
            if spec.svc is not None:
                # the service issues each entry in its agreed order, under
                # its own issue lock and then the issue lock (that order,
                # always)
                self._execute_negotiated(spec, entries)
            else:
                with program_issue.serialized():
                    if spec.kind in ("allreduce", "broadcast"):
                        # one grouped collective for the whole queue,
                        # through the dispatch plan cache
                        self._dispatch_units(
                            [entries],
                            lambda unit: self._run_fused_unit(spec, unit))
                    else:
                        self._dispatch_units([[e] for e in entries],
                                             self._unit_runner(spec))
        except BaseException as exc:
            self._fail_entries(entries, exc)
            hvd_logging.error("fusion cycle flush failed: %s", exc)
            if not isinstance(exc, Exception):
                raise

    def _unit_runner(self, spec: _QueueSpec):
        if spec.kind == "sparse":
            return self._run_opaque_unit
        return lambda unit: self._run_allgather_unit(spec, unit)

    def _settle(self, unit, handle) -> list:
        """Give each entry of a wire unit its part of ``handle``'s
        results."""
        i = 0
        for e in unit:
            e.results = _Part(handle, i, i + e.count)
            i += e.count
            e.tensors = ()
            e.run = None
        return list(unit)

    def _dispatch_units(self, units, run_unit) -> None:
        """Issue a flush as wire units (lists of entries whose tensors
        travel together); ``dispatches`` counts flush rounds and
        ``wire_programs`` the units issued."""
        settled = []
        try:
            for unit in units:
                settled += self._settle(unit, run_unit(unit))
        except BaseException:
            # units already issued keep their results: peers counted them
            for e in settled:
                e.event.set()
            self._qos_settle(settled)
            raise
        with self._mu:
            self._stats["dispatches"] += 1
            self._stats["wire_programs"] += len(units)
        for e in settled:
            e.event.set()
        self._qos_settle(settled)

    def _run_fused_unit(self, spec: _QueueSpec, unit: list[_Entry]):
        from . import collectives as _coll
        tensors = [t for e in unit for t in e.tensors]
        if spec.kind == "allreduce":
            return _coll._queued_grouped_allreduce(tensors, spec)
        return _coll._queued_grouped_broadcast(tensors, spec)

    def _run_allgather_unit(self, spec: _QueueSpec, unit: list[_Entry]):
        """An allgather entry issues alone, in submission order (its row
        counts are exchanged, or negotiated, per call)."""
        from . import collectives as _coll
        e, = unit
        return _coll._queued_allgather(e.tensors[0], spec, e.names[0])

    def _run_opaque_unit(self, unit: list[_Entry]):
        from .collectives import Handle
        e, = unit
        return Handle(result=[e.run()])

    def _execute_negotiated(self, spec: _QueueSpec,
                            entries: list[_Entry]) -> None:
        """A negotiated flush: each entry's requests went to the service
        at its enqueue (an entry held by a capture that fell back goes
        now); the service issues each in the agreed order (here, or
        already by another thread's ``run_until``), one wire unit an
        entry."""
        def run(unit):
            e, = unit
            if e.ticket is None:
                e.ticket = self._submit_entry(spec, e)
            spec.svc.run_until(e.ticket)
            return e.ticket.result

        self._dispatch_units([[e] for e in entries], run)

    # -- cycle timer -------------------------------------------------------

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop = _inv.make_event("fusion_cycle.scheduler.stop")
            self._thread = _inv.spawn_thread(
                self._loop, name="hvd-fusion-cycle")

    def _age_limit_s(self) -> float:
        """The queue age that triggers a cycle flush: ``CYCLE_TIME``, or
        ``PENDING_CYCLE_TIME`` within a cycle window of a dispatch."""
        cycle = envs.cycle_time_ms() / 1e3
        if _inv.monotonic() < self._inflight_until:
            return min(cycle, pending_cycle_time_ms() / 1e3)
        return cycle

    def _loop(self) -> None:
        stop = self._stop
        while not stop.is_set():
            self._wake.clear()
            now = _inv.monotonic()
            due: list[tuple] = []
            next_deadline = None
            with self._mu:
                limit = self._age_limit_s()
                for key, q in self._queues.items():
                    if not q.spec.single:
                        # a queue with peers never flushes from the timer:
                        # its drains must be points of the program
                        continue
                    deadline = q.oldest_t + limit
                    if deadline <= now:
                        due.append(key)
                    elif next_deadline is None or deadline < next_deadline:
                        next_deadline = deadline
            for key in due:
                if stop.is_set():
                    return
                try:
                    self.flush_queue(key, "cycle")
                except BaseException:
                    hvd_logging.exception("cycle flush failed on timer")
            if due:
                continue
            timeout = (None if next_deadline is None
                       else max(next_deadline - _inv.monotonic(), 0.0))
            self._wake.wait(timeout)

    # -- lifecycle / stats -------------------------------------------------

    def drain(self) -> None:
        """Issue everything still pending (a clean shutdown)."""
        self.flush_all("shutdown")

    def abort(self, reason: str) -> int:
        """Fail everything still pending without issuing it (a service
        reset: the world the entries were negotiated against is gone): the
        queues, the executor's unstarted batches (their negotiations are
        cancelled) and the capture's held entries. Returns how many
        entries failed; their handles raise at ``synchronize()``."""
        with self._mu:
            queues = list(self._queues.values())
            self._queues.clear()
            self._pending_tensors = 0
            self._pending_bytes = 0
        with self._exec_cv:
            batches = list(self._exec_q)
            self._exec_q.clear()
            self._issued_seq += len(batches)  # nothing waits for them
            if self._qos_gate is not None:
                batches.extend(self._qos_gate.drain_locked())
            for b in batches:
                for e in b.entries:
                    if e.requests:
                        self._exec_names.difference_update(e.names)
                    e.qos_inflight = False
            self._qos_epoch += 1
            self._qos_unacked.clear()
            self._qos_inflight.clear()
            self._exec_cv.notify_all()
        n = 0

        def fail(e):
            e.error = RuntimeError(
                f"queued collective {e.label!r} aborted: {reason}")
            e.tensors = ()
            e.run = None
            e.event.set()

        dead = [(q.spec, e) for q in queues for e in q.entries]
        dead += [(b.spec, e) for b in batches for e in b.entries
                 if not e.done]
        for spec, e in dead:
            if e.ticket is not None:
                try:
                    spec.svc.cancel(e.ticket)
                except Exception:
                    pass  # the service may already be gone
            fail(e)
            n += 1
        n += self.capture.abort(reason)
        return n

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            _inv.join_thread(t, timeout=5)
        self._thread = None
        with self._exec_cv:
            self._exec_stop = True
            self._exec_cv.notify_all()
        t = self._exec_thread
        if t is not None and t is not threading.current_thread():
            _inv.join_thread(t, timeout=5)
        self._exec_thread = None
        self._exec_inflight.clear()

    def stats(self) -> dict:
        slots = max(envs.max_inflight_flushes(), 1)
        capture = self.capture.stats()
        with self._exec_cv:
            executed = self._pstats["executed"]
            qos = {"enabled": _qos.enabled(),
                   "shed": dict(self._qos_stats["shed"]),
                   "quota_blocks": self._qos_stats["quota_blocks"],
                   "unacked_bytes": dict(self._qos_unacked),
                   "inflight_bytes": dict(self._qos_inflight)}
            if self._qos_gate is not None:
                qos.update(self._qos_gate.stats_locked())
            pipeline = {
                "enabled": envs.pipeline_enabled(),
                "max_inflight": envs.max_inflight_flushes(),
                "chunking": envs.pipeline_chunking_enabled(),
                "pipeline_threshold_bytes": envs.pipeline_threshold_bytes(),
                "pipeline_chunks": envs.pipeline_chunks(),
                "submitted": self._pstats["submitted"],
                "executed": executed,
                "queue_depth": len(self._exec_q),
                "inflight_peak": self._pstats["inflight_peak"],
                "slot_waits": self._pstats["slot_waits"],
                "device_wait_ms": self._pstats["device_wait_ms"],
                "overlap_ratio": (self._pstats["overlapped"] / executed
                                  if executed else 0.0),
                "slot_occupancy": (
                    (self._pstats["depth_sum"] / executed + 1.0) / slots
                    if executed else 0.0),
            }
        with self._mu:
            flushes = dict(self._stats["flushes"])
            dispatches = self._stats["dispatches"]
            flushed = self._stats["flushed_tensors"]
            total_flushes = sum(flushes.values())
            return {
                "enabled": enabled(),
                "cycle_time_ms": envs.cycle_time_ms(),
                "pending_cycle_time_ms": pending_cycle_time_ms(),
                "fusion_threshold_bytes": envs.fusion_threshold_bytes(),
                "max_pending_bytes": max_pending_bytes(),
                "enqueued_tensors": self._stats["enqueued_tensors"],
                "enqueued_bytes": self._stats["enqueued_bytes"],
                "pending_tensors": self._pending_tensors,
                "pending_bytes": self._pending_bytes,
                "flushes": {**flushes, "total": total_flushes},
                "flushed_tensors": flushed,
                "flushed_bytes": self._stats["flushed_bytes"],
                "dispatches": dispatches,
                "wire_programs": self._stats["wire_programs"],
                "tensors_per_flush": (flushed / total_flushes
                                      if total_flushes else 0.0),
                "bytes_per_flush": (self._stats["flushed_bytes"]
                                    / total_flushes if total_flushes
                                    else 0.0),
                "coalesce_ratio": (flushed / dispatches if dispatches
                                   else 0.0),
                "pipeline": pipeline,
                "qos": qos,
                "capture": capture,
            }

    def reset_stats(self) -> None:
        with self._mu:
            self._stats = self._zero_stats()
            self.flush_history.clear()
        with self._exec_cv:
            self._pstats = self._zero_pstats()
            self._qos_stats = {"shed": {}, "quota_blocks": 0}
        self.capture.reset_stats()


# ---------------------------------------------------------------------------
# the process's scheduler and the enqueue front door of the async ops
# ---------------------------------------------------------------------------

_scheduler: FusionScheduler | None = None
_scheduler_lock = threading.Lock()


def scheduler() -> FusionScheduler:
    global _scheduler
    if _scheduler is None:
        with _scheduler_lock:
            if _scheduler is None:
                _scheduler = FusionScheduler()
    return _scheduler


def _current_scheduler() -> FusionScheduler | None:
    """The scheduler, without making one."""
    return _scheduler


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def plan_sig(t) -> tuple | None:
    """A tensor's plan signature, the JAX package's ``("r", shape, dtype
    name)`` of an input every rank passes; None for a non-tensor."""
    if not isinstance(t, torch.Tensor):
        return None
    return ("r", tuple(t.shape), _dtype_name(t.dtype))


def _entry_nbytes(tensors, wire_dts) -> int:
    return sum(t.numel() * dt.itemsize for t, dt in zip(tensors, wire_dts))


def queue_allreduce(tensors, *, grouped: bool, op, process_set=None,
                    prescale_factor=1.0, postscale_factor=1.0, name=None,
                    compression=None):
    """Enqueue an async (grouped) allreduce; returns a queued handle, or
    None where the submission takes the immediate path (scheduler off,
    Adasum, a custom compressor, a non-tensor input)."""
    from .. import engine_service
    from ..dynamic import REQ_ALLREDUCE
    from ..process_sets import _resolve
    from . import collectives as _coll
    from . import hierarchical
    from .reduce_ops import ReduceOp

    if not tensors or not enabled() or op == ReduceOp.ADASUM:
        return None
    sigs = [plan_sig(t) for t in tensors]
    if any(s is None for s in sigs):
        return None
    if _coll._is_custom_compressor(compression):
        return None
    if getattr(compression, "wire_dtype", None) is None:
        compression = None  # none-compression is no compression: one queue
    pset = _resolve(process_set)
    for t in tensors:
        _coll._check_op_dtype(op, t.dtype)
    svc = engine_service.get_service(pset)
    wire = getattr(compression, "wire_dtype", None)
    comp_key = _dtype_name(wire) if wire is not None else None
    wire_dts = [_coll._wire_dtype_of(t, compression) for t in tensors]
    key = ("allreduce", dispatch_key(pset), None, int(op),
           float(prescale_factor), float(postscale_factor),
           hierarchical.enabled(envs.HIERARCHICAL_ALLREDUCE, pset)
           and op in (ReduceOp.SUM, ReduceOp.AVERAGE), comp_key)
    requests: list[dict] = []
    if grouped:
        base = name or _coll._auto_name("q_grouped_allreduce", pset)
        names = [f"{base}.{i}" for i in range(len(tensors))]
    elif name is not None:
        names = [name]
    else:
        names = [_coll._auto_name("q_allreduce", pset)]
    if svc is not None:
        # the op and scales as given, as the immediate path negotiates
        # them: a joined rank rebuilds the entry's composition from them
        if grouped:
            requests = _coll._group_requests(
                names[0].rsplit(".", 1)[0], REQ_ALLREDUCE,
                [(t.shape, w) for t, w in zip(tensors, wire_dts)],
                reduce_op=int(op), prescale=float(prescale_factor),
                postscale=float(postscale_factor))
        else:
            requests = [_coll._request(
                names[0], REQ_ALLREDUCE, tensors[0].shape, wire_dts[0],
                reduce_op=int(op), prescale=float(prescale_factor),
                postscale=float(postscale_factor))]
    spec = _QueueSpec("allreduce", pset, op=op, pre=float(prescale_factor),
                      post=float(postscale_factor), compression=compression,
                      svc=svc)
    entry = _Entry(list(tensors), grouped, _entry_nbytes(tensors, wire_dts),
                   names, requests, label=names[0])
    entry.sigs = tuple(sigs)
    scheduler().enqueue(key, spec, entry)
    return _coll._QueuedHandle(entry)


def queue_broadcast(tensor, root_rank: int, *, process_set=None, name=None):
    from .. import engine_service
    from ..dynamic import REQ_BROADCAST
    from ..process_sets import _resolve
    from . import collectives as _coll

    if not enabled():
        return None
    sig = plan_sig(tensor)
    if sig is None:
        return None
    pset = _resolve(process_set)
    _coll._check_root(root_rank, pset)
    svc = engine_service.get_service(pset)
    key = ("broadcast", dispatch_key(pset), None, int(root_rank))
    names = [name or _coll._auto_name("q_broadcast", pset)]
    requests: list[dict] = []
    if svc is not None:
        requests = [_coll._request(names[0], REQ_BROADCAST, tensor.shape,
                                   tensor.dtype, root_rank=int(root_rank))]
    spec = _QueueSpec("broadcast", pset, root_rank=int(root_rank), svc=svc)
    entry = _Entry([tensor], False, _entry_nbytes([tensor], [tensor.dtype]),
                   names, requests, label=names[0])
    entry.sigs = (sig,)
    scheduler().enqueue(key, spec, entry)
    return _coll._QueuedHandle(entry)


def queue_allgather(tensor, *, process_set=None, name=None):
    from .. import engine_service
    from ..process_sets import _resolve
    from . import collectives as _coll

    if not enabled() or plan_sig(tensor) is None:
        return None
    pset = _resolve(process_set)
    svc = engine_service.get_service(pset)
    key = ("allgather", dispatch_key(pset), None)
    # under a service the name is drawn now, at submission, from the
    # allgather counter the immediate calls share
    auto = _coll._auto_name("allgather", pset) if svc is not None else None
    names = [name if name is not None else auto]
    requests = []
    if svc is not None:
        from ..dynamic import REQ_ALLGATHER
        requests = [_coll._request(names[0], REQ_ALLGATHER, tensor.shape,
                                   tensor.dtype)]
    spec = _QueueSpec("allgather", pset, svc=svc)
    entry = _Entry([tensor], False, _entry_nbytes([tensor], [tensor.dtype]),
                   names, requests, label=names[0] or "allgather")
    scheduler().enqueue(key, spec, entry)
    return _coll._QueuedHandle(entry)


def queue_opaque(kind: str, run, *, process_set=None, nbytes: int = 0,
                 label: str = "", extra_key=()):
    """An entry with its own executor (the sparse async path): no fusion
    across entries, but a burst drains in one flush."""
    from .. import engine_service
    from ..process_sets import _resolve
    from . import collectives as _coll

    if not enabled():
        return None
    pset = _resolve(process_set)
    if engine_service.get_service(pset) is not None:
        return None  # it negotiates at the call (see the module's notes)
    key = (kind, dispatch_key(pset)) + tuple(extra_key)
    spec = _QueueSpec("sparse", pset)
    entry = _Entry([None], False, int(nbytes),
                   [label or _coll._auto_name("q_" + kind, pset)], run=run,
                   label=label)
    scheduler().enqueue(key, spec, entry)
    return _coll._QueuedHandle(entry)


# -- module-level conveniences ------------------------------------------------

def flush_all(trigger: str = "barrier") -> None:
    sched = _current_scheduler()
    if sched is not None:
        sched.flush_all(trigger)


def fusion_flush() -> None:
    """Drain every pending queue into the executor and wait until all of
    it has been issued (``hvd.fusion_flush()``): weaker than
    ``hvd.barrier()``, with no rendezvous and no wait for the device."""
    flush_all("barrier")


def drain() -> None:
    """At ``hvd.shutdown()``: issue everything still queued, then stop the
    threads."""
    sched = _current_scheduler()
    if sched is not None:
        sched.drain()
        sched.stop()


def abort(reason: str) -> int:
    """At a service reset: fail the pending entries."""
    sched = _current_scheduler()
    if sched is not None:
        return sched.abort(reason)
    return 0


def stop() -> None:
    """Stop the scheduler's threads without issuing anything (a failed
    world's teardown, after :func:`abort`); they start again at the next
    enqueue."""
    sched = _current_scheduler()
    if sched is not None:
        sched.stop()


def stats() -> dict:
    """Scheduler counters (``hvd.fusion_stats()``)."""
    return scheduler().stats()


def reset() -> None:
    """Tests / teardown: abort the queues, stop the threads, drop the
    scheduler."""
    global _scheduler
    with _scheduler_lock:
        sched, _scheduler = _scheduler, None
    if sched is not None:
        sched.abort("fusion scheduler reset")
        sched.stop()
