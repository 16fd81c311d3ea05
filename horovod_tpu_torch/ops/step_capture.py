"""Step capture-and-replay: a whole step's sync as one CUDA Graph (port of
``horovod_tpu/ops/step_capture.py``).

The flush stream of a training step is a pure function of the submission
order and the names drawn at enqueue, so it is the same every step and on
every rank, and can be recorded. This module records the flush stream of
one marked step as it flows through ``ops/fusion_cycle.py`` (signatures,
grouping, wire dtypes, names), then replays later steps' collective work
at once: on the card as **one CUDA Graph** of the pack (cast and prescale
into the wire buffers), the NCCL collectives and the unpack (postscale
and cast back), captured on a stream of the sync's own at the first
replay and launched with ``replay()`` after that. The handles,
``synchronize()`` and ``poll()`` behave as before; only the dispatch
under them changes.

Lifecycle (``HVD_STEP_CAPTURE=1``), the reference's:

* ``hvd.step_marker()`` marks a step boundary (a bare call per loop
  iteration, or ``with hvd.step_marker():`` around the step). The
  optimizer's bucket sync opens a region itself (:func:`auto_region`)
  when the knob is on and no user region is open.
* The first marked step RECORDS: every flush drained in the region
  appends a :class:`_FlushRecord` while it executes eagerly as usual.
* The boundary SEALS the record into a :class:`StepPlan` keyed by the
  stream's content (never by auto names) and arms REPLAY.
* During replay, submissions are matched against the record and held;
  when the last recorded one arrives, the whole step's work issues.
* A divergence (a shape or dtype that changed, a new tensor, another
  composition, a blocking ``synchronize`` before the stream completed, a
  barrier's drain, ``abort()``, a knob override's epoch, and on the card
  an input that moved: its ``data_ptr`` and strides are part of the
  match, since the graph reads fixed addresses) falls back: the held
  entries execute eagerly in their recorded composition, the step is
  counted in ``fallbacks``, and the next marked step records again.
* A region in which nothing was submitted keeps the plan armed.

Under a negotiation service a replay is one ``negotiate_step`` round for
the whole step's requests and then each entry's recorded composition (the
joined-rank contract forbids re-fusing them), with no graph.

**The replay's results are its inputs.** The unpack writes each result
into its input tensor in place, so no result aliases the graph's pool,
which the next replay overwrites; a replayed allreduce whose result dtype
differs from its input's (an integer with a postscale) makes the stream
uncapturable. The optimizer keeps its gradients in place
(``zero_grad(set_to_none=False)``) so that their addresses hold from step
to step. On the host (gloo cannot be captured) the replay runs the same
fused composition as plain calls and writes the results in place too:
that is the plain version the tests hold; nothing on the card takes it. A
capture or replay error fails the held entries' handles, which raise at
``synchronize()``: there is no quiet fallback to the eager path.

The ``capture`` block of ``hvd.fusion_stats()`` reports the lifecycle;
``hvd.dispatch_cache_stats()["hits_by_source"]["step"]`` counts replays.
"""

from __future__ import annotations

import zlib as _zlib

import torch

from .. import autotune as _autotune
from .. import conformance as _conformance
from .. import metrics as _metrics
from .. import timeline as _timeline
from ..utils import envs
from ..utils import invariants as _inv
from ..utils import logging as hvd_logging
from . import dispatch_cache as _dispatch

# flush triggers by which the caller blocks on the entry: a held entry
# observed through one before the stream completed is a divergence
_BLOCKING_TRIGGERS = ("synchronize", "poll")


def _layout(tensors) -> tuple:
    """The addresses a graph reads: each input's ``data_ptr`` and
    strides."""
    return tuple((t.data_ptr(), tuple(t.stride())) for t in tensors)


class _EntryTemplate:
    """The matchable shape of one recorded submission: queue key,
    grouping, tensor count and plan signatures. Names are kept for the
    seal-time duplicate check but are not part of the signature (auto
    names advance counters the stream's content does not own)."""

    __slots__ = ("key", "grouped", "count", "sigs", "names")

    def __init__(self, key, grouped, count, sigs, names=()):
        self.key = key
        self.grouped = grouped
        self.count = count
        self.sigs = sigs
        self.names = names

    def matches(self, entry) -> bool:
        return (entry.grouped == self.grouped
                and entry.count == self.count
                and getattr(entry, "sigs", None) == self.sigs)

    def signature(self) -> tuple:
        return (self.grouped, self.count, self.sigs)


class _FlushRecord:
    """One recorded flush: its queue spec, its entry templates in
    submission order, and its trigger."""

    __slots__ = ("spec", "templates", "trigger")

    def __init__(self, spec, templates, trigger):
        self.spec = spec
        self.templates = templates
        self.trigger = trigger

    def signature(self) -> tuple:
        return (self.templates[0].key if self.templates else (),
                tuple(t.signature() for t in self.templates))


class StepPlan(_dispatch.DispatchPlan):
    """A sealed capture: the recorded stream and the whole-step executor
    ``execute(entries per record) -> one handle per record``, stored in
    the plan cache under ``("step", knobs..., key)`` so every invalidation
    path drops it like any other plan. ``layouts`` holds, once a graph is
    captured, the addresses each held entry must present."""

    __slots__ = ("key", "records", "entries_total", "layouts", "graph")

    def __init__(self, key, records, run_step, nbytes, pieces):
        super().__init__("step", "STEP_REPLAY", nbytes, None, run_step,
                         variant="step", pieces=pieces)
        self.key = key
        self.records = records
        self.entries_total = sum(len(r.templates) for r in records)
        self.layouts = None
        self.graph = None


# ---------------------------------------------------------------------------
# whole-step executors
# ---------------------------------------------------------------------------

def _fuse_groups(records):
    """One group a recorded flush, in stream order. The JAX package fuses
    every flush of a queue key into one set of wire buffers; here each
    flush keeps its own, the eager path's, so that a ring's reduction
    order over each buffer (which follows its length) is the eager
    path's, and the replay's results are the eager path's bit for bit."""
    return [{"spec": rec.spec, "records": [ri]}
            for ri, rec in enumerate(records)]


def _in_place_ok(spec, sigs) -> bool:
    """Whether every result of a recorded group keeps its input's dtype,
    so that the replay can write it in place."""
    from . import collectives as _coll
    from .reduce_ops import handle_average
    if spec.kind == "broadcast":
        return True
    lowered, post = handle_average(spec.op, spec.pset.size(), spec.post)
    for s in sigs:
        dt = getattr(torch, s[2])
        src = torch.float32 if (spec.op.name == "AVERAGE"
                                and dt == torch.bool) else dt
        if spec.pre != 1.0:
            src = torch.result_type(torch.empty((), dtype=src), spec.pre)
        if _coll._reduced_dtype(src, lowered, post) != dt:
            return False
    return True


def _group_body(spec, tensors) -> None:
    """One group's pack, collectives and unpack: the results written into
    ``tensors`` in place (the body a graph captures, and the host's plain
    replay)."""
    from . import collectives as _coll
    if spec.kind == "broadcast":
        outs = _coll._run_queued_broadcast(tensors, spec).synchronize()
    else:
        outs = _coll._run_queued_allreduce(tensors, spec,
                                           "step").synchronize()
    for t, r in zip(tensors, outs):
        if r is not t:
            t.copy_(r)


_replay_streams: dict = {}


def _replay_stream(device: torch.device):
    """The stream a captured step's graph is captured and replayed on: its
    own, apart from the flush executor's, so that no other thread's work
    can land in a capture."""
    stream = _replay_streams.get(device)
    if stream is None:
        stream = _replay_streams[device] = torch.cuda.Stream(device)
    return stream


def _results_of(entries):
    """The finish of a replayed record's handle: its inputs, which hold
    the results."""
    tensors = [t for e in entries for t in e.tensors]
    return lambda: tensors


class _GraphStep:
    """The executor of a stream without a service: each recorded flush's
    fused collective. On the card the first replay captures the groups' bodies
    as one CUDA Graph on the sync's stream and later replays launch it;
    on the host the bodies run as plain calls."""

    def __init__(self, records):
        self.records = records
        self.groups = _fuse_groups(records)
        self.graph = None

    def __call__(self, entries_per_record, plan):
        from . import collectives as _coll
        from . import program_issue
        tensors = {id(g): [t for ri in g["records"]
                           for e in entries_per_record[ri]
                           for t in e.tensors] for g in self.groups}
        flat = [t for ts in tensors.values() for t in ts]
        if not flat[0].is_cuda:
            with program_issue.ordered():
                for g in self.groups:
                    _group_body(g["spec"], tensors[id(g)])
            return [_coll.Handle(result=[t for e in es for t in e.tensors])
                    for es in entries_per_record]
        device = flat[0].device
        stream = _replay_stream(device)
        for es in entries_per_record:
            for e in es:
                if e.ready is not None:
                    stream.wait_event(e.ready)
        with program_issue.ordered():
            if self.graph is None:
                self._capture(stream, tensors)
                plan.layouts = {(ri, ei): _layout(e.tensors)
                                for ri, es in enumerate(entries_per_record)
                                for ei, e in enumerate(es)}
                plan.graph = self.graph
            with torch.cuda.stream(stream):
                self.graph.replay()
            done = _coll._stream_done(stream)
        # the consumer's stream waits for the replay at synchronize()
        return [_coll.Handle([done], _results_of(es))
                for es in entries_per_record]

    def _capture(self, stream, tensors) -> None:
        """Capture every group's body into one graph. The communicators
        are warm: the recording step ran the same collectives eagerly.
        ``thread_local``: the negotiation cycle and the autograd thread
        make CUDA calls meanwhile."""
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            for g in self.groups:
                _group_body(g["spec"], tensors[id(g)])
        self.graph = graph


def _make_svc_execute(records):
    """The executor of a negotiated stream: one ``negotiate_step`` round
    for every flush of the step, then each entry's recorded composition
    (what a joined rank rebuilds from the plan), in the service's agreed
    order."""
    pset = records[0].spec.pset
    build_svc = records[0].spec.svc

    def execute(entries_per_record, plan):
        del plan
        from .. import engine_service
        from . import collectives as _coll
        reqs = [r for entries in entries_per_record
                for e in entries for r in e.requests]
        svc = engine_service.get_service(pset) or build_svc

        def issue(_responses):
            out = []
            for rec, entries in zip(records, entries_per_record):
                spec = rec.spec
                if spec.kind == "broadcast":
                    out.append([_coll._run_queued_broadcast(
                        [t for e in entries for t in e.tensors], spec)])
                else:
                    out.append([_coll._run_queued_allreduce(
                        e.tensors, spec, e.label) for e in entries])
            return out

        item = svc.submit_step(reqs, issue)
        svc.run_until(item)
        return [_coll.Handle(result=[r for h in handles
                                     for r in h.synchronize()])
                for handles in item.result]

    return execute


def _store_key(key: tuple) -> tuple:
    """The plan-cache key of a sealed capture: the stream's content and
    the raw values of the knobs its executor bakes in (the fusion
    threshold sets the wire buffers; the chunking knobs their chunks)."""
    from . import collectives as _coll
    return _dispatch.fold_knobs("step", key, envs.fusion_threshold_bytes(),
                                _coll._pipeline_key(), envs.mesh_axes())


_PHASE_CODES = {"idle": 0, "record": 1, "replay": 2, "replayed": 3,
                "bypass": 4}


def _note_capture(event: str | None = None,
                  state: str | None = None) -> None:
    """Mirror a lifecycle event and/or phase onto the metrics registry."""
    if event is not None:
        _metrics.STEP_CAPTURE_STEPS.inc(labels={"event": event})
    if state is not None:
        _metrics.STEP_CAPTURE_PHASE.set(_PHASE_CODES.get(state, 0))


class CaptureState:
    """The capture lifecycle of one ``FusionScheduler``: ``idle``,
    ``record`` (flushes execute eagerly and are recorded), ``replay``
    (armed: submissions are matched and held), ``replayed``, ``bypass``
    (a divergence dropped this step back to eager). Lock order: ``_mu``
    may be held while taking the plan cache's lock, never the
    scheduler's; fallbacks and replays run outside it."""

    def __init__(self, sched):
        self._sched = sched
        self._mu = _inv.make_lock("step_capture.mu")
        self._state = "idle"
        self._region_open = False
        self._recording = False
        self._replaying = False
        self._records: list = []
        self._plan: StepPlan | None = None
        self._last_key: tuple | None = None
        self._expect: dict = {}
        self._held: dict = {}
        self._matched = 0
        self._total = 0
        self._stats = self._zero_stats()

    @staticmethod
    def _zero_stats() -> dict:
        return {"recorded_steps": 0, "captured_flushes": 0,
                "plan_builds": 0, "replayed_steps": 0,
                "replayed_entries": 0, "fallbacks": 0, "invalidations": 0,
                "uncapturable_steps": 0, "graph_launches": 0,
                "graph_captures": 0, "moved_inputs": 0}

    # -- configuration -----------------------------------------------------

    def enabled(self) -> bool:
        return envs.step_capture_enabled()

    def region_open(self) -> bool:
        return self._region_open

    # -- step boundaries ---------------------------------------------------

    def boundary(self, closing: bool = False) -> None:
        """Close the current region (seal a record, verify a replay) and,
        unless ``closing``, open the next: armed when a plan for the last
        stream is cached, else recording."""
        if not self.enabled() and self._state == "idle" \
                and not self._region_open:
            return
        prev_state = self._state
        fallback = None
        with self._mu:
            if self._state == "record":
                self._seal_locked()
            elif self._state == "replay":
                if self._matched == 0 and not self._held:
                    # an empty region: nothing diverged, the plan stays
                    self._expect = {}
                    self._total = 0
                else:
                    # the step ended before the stream completed
                    fallback = self._take_held_locked()
                    self._diverge_locked()
            self._state = "idle"
            self._replaying = self._recording = False
            self._region_open = False
        if fallback:
            self._run_fallback(fallback)
        if closing or not self.enabled():
            _conformance.record(
                "ops/step_capture.py::CaptureState.boundary", "phase",
                (prev_state, "idle"))
            return
        with self._mu:
            self._region_open = True
            plan = None
            if self._last_key is not None:
                plan = _dispatch.lookup(_store_key(self._last_key),
                                        record_stats=False)
                if not isinstance(plan, StepPlan):
                    self._stats["invalidations"] += 1
                    _note_capture("invalidated")
                    self._last_key = None
                    plan = None
            if plan is not None:
                self._arm_locked(plan)
            elif _dispatch.enabled():
                self._records = []
                self._state = "record"
                self._recording = True
            else:
                self._state = "bypass"  # no plan could be stored
        _note_capture(state=self._state)
        _conformance.record(
            "ops/step_capture.py::CaptureState.boundary", "phase",
            (prev_state, self._state))
        _timeline.record_capture(
            "REPLAY" if self._replaying
            else ("RECORD" if self._recording else "BYPASS"))

    def _seal_locked(self) -> None:
        records, self._records = self._records, []
        self._recording = False
        if not records:
            return
        self._stats["recorded_steps"] += 1
        self._stats["captured_flushes"] += len(records)
        _note_capture("recorded")
        key = tuple(r.signature() for r in records)
        _conformance.record(
            "ops/step_capture.py::CaptureState._seal_locked", "seal",
            (len(records), _zlib.crc32(repr(key).encode()) & 0xFFFFFFFF))
        cached = _dispatch.lookup(_store_key(key), record_stats=False)
        if isinstance(cached, StepPlan):
            self._last_key = key
            return
        try:
            plan = self._default_build_plan(key, records)
        except Exception as exc:
            hvd_logging.error("step capture plan build failed: %s", exc)
            plan = None
        if plan is None:
            self._stats["uncapturable_steps"] += 1
            _note_capture("uncapturable")
            self._last_key = None
            return
        self._stats["plan_builds"] += 1
        _dispatch.store(_store_key(key), plan)
        self._last_key = key
        _timeline.record_capture("SEAL")

    def _default_build_plan(self, key, records):
        """The StepPlan of a sealed record, or None when the stream cannot
        be captured: another kind than allreduce and broadcast, a
        non-tensor entry, single and negotiated flushes mixed, a user name
        repeated in a negotiated step, or a result that cannot be written
        in place."""
        svc = records[0].spec.svc
        for rec in records:
            if rec.spec.kind not in ("allreduce", "broadcast"):
                return None
            if any(t.sigs is None for t in rec.templates):
                return None
            if (rec.spec.svc is None) != (svc is None) \
                    or (svc is not None and rec.spec.svc is not svc):
                return None
        if svc is not None:
            names = [n for rec in records for t in rec.templates
                     for n in t.names]
            if len(names) != len(set(names)):
                return None
            run_step = _make_svc_execute(records)
        else:
            for rec in records:
                if not _in_place_ok(rec.spec, [s for t in rec.templates
                                               for s in t.sigs]):
                    return None
            run_step = _GraphStep(records)
        nbytes = sum(t.count and sum(
            _numel(s) * getattr(torch, s[2]).itemsize for s in t.sigs)
            for rec in records for t in rec.templates)
        return StepPlan(key, records, run_step, nbytes, len(records))

    def _arm_locked(self, plan: StepPlan) -> None:
        self._plan = plan
        self._expect = {}
        self._held = {}
        self._matched = 0
        self._total = 0
        for ri, rec in enumerate(plan.records):
            for ei, tmpl in enumerate(rec.templates):
                seq = self._expect.setdefault(
                    tmpl.key, {"templates": [], "pos": 0})
                seq["templates"].append((ri, ei, tmpl))
                self._total += 1
        self._state = "replay"
        self._replaying = True

    # -- recording ---------------------------------------------------------

    def note_flush(self, spec, entries, trigger) -> None:
        """Record one drained flush (record mode only; it still executes
        eagerly)."""
        if not self._recording:
            return
        with self._mu:
            if self._state != "record":
                return
            templates = [
                _EntryTemplate(e.queue_key, e.grouped, e.count,
                               getattr(e, "sigs", None), e.names)
                for e in entries
            ]
            self._records.append(_FlushRecord(spec, templates, trigger))

    # -- replay ------------------------------------------------------------

    def offer(self, key, spec, entry) -> bool:
        """Replay intake: match the entry against the recorded stream and
        hold it. True when held; False sends it down the eager path (no
        replay armed, or it just diverged)."""
        del spec
        if not self._replaying:
            return False
        run = plan = None
        fallback = None
        diverged = False
        with self._mu:
            if self._state != "replay":
                return False
            seq = self._expect.get(key)
            tmpl = None
            if seq is not None and seq["pos"] < len(seq["templates"]):
                ri, ei, tmpl = seq["templates"][seq["pos"]]
            moved = (tmpl is not None and self._plan.layouts is not None
                     and self._plan.layouts.get((ri, ei))
                     != _layout(entry.tensors))
            if tmpl is None or not tmpl.matches(entry) or moved:
                stale = None
                if moved and tmpl.matches(entry):
                    # its graph reads the old addresses: the next record
                    # of this stream captures a new one
                    self._stats["moved_inputs"] += 1
                    stale = _store_key(self._plan.key)
                fallback = self._take_held_locked()
                self._diverge_locked()
                diverged = True
                if stale is not None:
                    _dispatch.drop(stale)
            else:
                seq["pos"] += 1
                entry.captured = True
                self._held[(ri, ei)] = entry
                self._matched += 1
                if self._matched == self._total:
                    plan = self._plan
                    run = self._take_held_locked()
                    self._state = "replayed"
                    self._replaying = False
        if diverged:
            if fallback:
                self._run_fallback(fallback)
            return False
        if run is not None:
            self._execute_replay(plan, run)
        return True

    def _take_held_locked(self) -> list:
        """Held entries grouped per record in stream order (partial groups
        when taken mid-stream for a fallback)."""
        held, self._held = self._held, {}
        plan = self._plan
        if not held or plan is None:
            return []
        groups = []
        for ri, rec in enumerate(plan.records):
            es = [held[(ri, ei)] for ei in range(len(rec.templates))
                  if (ri, ei) in held]
            if es:
                groups.append((rec, es))
        return groups

    def _diverge_locked(self) -> None:
        _conformance.record(
            "ops/step_capture.py::CaptureState._diverge_locked", "phase",
            (self._state, "bypass"))
        self._stats["fallbacks"] += 1
        self._stats["invalidations"] += 1
        _note_capture("fallback", state="bypass")
        _note_capture("invalidated")
        self._plan = None
        self._last_key = None
        self._expect = {}
        self._matched = self._total = 0
        self._state = "bypass"
        self._replaying = False

    def _run_fallback(self, groups) -> None:
        """Execute held entries eagerly in their recorded composition."""
        _timeline.record_capture("FALLBACK")
        svc_names = {n for _rec, es in groups for e in es
                     if e.requests for n in e.names}
        if svc_names:
            self._sched._wait_names_clear(svc_names)
        for i, (rec, es) in enumerate(groups):
            try:
                self._sched._execute(rec.spec, es)
            except BaseException as exc:
                for _rec2, es2 in groups[i:]:
                    self._sched._fail_entries(es2, exc)
                raise

    def _execute_replay(self, plan: StepPlan, groups) -> None:
        """Issue the whole step's work and settle the held entries."""
        from .fusion_cycle import _Part
        entries = [e for _rec, es in groups for e in es]
        svc_names = {n for e in entries if e.requests for n in e.names}
        if svc_names:
            self._sched._wait_names_clear(svc_names)
        captured = plan.graph is not None
        try:
            with _inv.section("fusion-cycle-flush"), \
                    _timeline.op_range("step", "STEP_REPLAY"), \
                    _dispatch.dispatch_source("step"):
                handles = plan.execute([es for _rec, es in groups], plan)
            _dispatch.note_step_hit()
            if plan.nbytes:
                _autotune.record(plan.nbytes)
        except BaseException as exc:
            self._sched._fail_entries(entries, exc)
            hvd_logging.error("step replay failed: %s", exc)
            with self._mu:
                self._stats["invalidations"] += 1
                _note_capture("invalidated")
                self._plan = None
                self._last_key = None
            _dispatch.drop(_store_key(plan.key))
            if not isinstance(exc, Exception):
                raise
            return
        for (rec, es), handle in zip(groups, handles):
            i = 0
            for e in es:
                e.results = _Part(handle, i, i + e.count)
                i += e.count
                e.tensors = ()
                e.run = None
                e.event.set()
        with self._mu:
            self._stats["replayed_steps"] += 1
            self._stats["replayed_entries"] += len(entries)
            if plan.graph is not None:
                self._stats["graph_launches"] += 1
                self._stats["graph_captures"] += not captured
        _conformance.record(
            "ops/step_capture.py::CaptureState._execute_replay",
            "replayed", (len(groups),))
        _note_capture("replayed", state="replayed")
        _timeline.record_capture("REPLAY_DONE")

    # -- interception / teardown -------------------------------------------

    def intercept_flush(self, entry, trigger) -> bool:
        """A held entry's flush request: a dispatch hint (the optimizer's
        ``bucket``, a threshold) defers to the replay; a blocking
        observation before the stream completed is a divergence, and
        everything held executes eagerly so the caller never hangs."""
        if not getattr(entry, "captured", False) or entry.done:
            return False
        if trigger not in _BLOCKING_TRIGGERS:
            return True
        fallback = None
        with self._mu:
            if self._state == "replay" \
                    and any(e is entry for e in self._held.values()):
                fallback = self._take_held_locked()
                self._diverge_locked()
        if fallback:
            self._run_fallback(fallback)
        return True

    def flush_pending(self, trigger: str) -> None:
        """``flush_all`` mid-replay: the held prefix executes eagerly."""
        del trigger
        fallback = None
        with self._mu:
            if self._state == "replay" and self._held:
                fallback = self._take_held_locked()
                self._diverge_locked()
        if fallback:
            self._run_fallback(fallback)

    def abort(self, reason: str) -> int:
        """Fail every held entry and drop the record and the armed plan.
        Returns how many entries failed."""
        with self._mu:
            held = list(self._held.values())
            self._held = {}
            self._expect = {}
            self._records = []
            if (self._plan is not None or self._last_key is not None
                    or self._state in ("record", "replay")):
                self._stats["invalidations"] += 1
                _note_capture("invalidated")
            self._plan = None
            self._last_key = None
            self._matched = self._total = 0
            self._state = "bypass" if self._region_open else "idle"
            self._replaying = self._recording = False
        n = 0
        for e in held:
            if not e.done:
                e.error = RuntimeError(
                    f"captured collective {e.label!r} aborted: {reason}")
                e.tensors = ()
                e.run = None
                e.event.set()
                n += 1
        return n

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        """The JAX package's ``capture`` block, and the port's graph
        counters: ``graph_launches`` (replays that launched a CUDA Graph),
        ``graph_captures`` (graphs captured) and
        ``moved_inputs`` (divergences by an input's address alone)."""
        with self._mu:
            out = dict(self._stats)
            out["enabled"] = self.enabled()
            out["state"] = self._state
            out["held_entries"] = len(self._held)
            out["armed"] = self._plan is not None
            return out

    def reset_stats(self) -> None:
        with self._mu:
            self._stats = self._zero_stats()


def _numel(sig) -> int:
    n = 1
    for d in sig[1]:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# public API (hvd.step_marker)
# ---------------------------------------------------------------------------

class _Region:
    """What :func:`step_marker` returns: usable bare, or as a context
    manager that closes the region on exit."""

    __slots__ = ("_cap",)

    def __init__(self, cap):
        self._cap = cap

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._cap.boundary(closing=True)
        return False


def step_marker() -> _Region:
    """Mark a training-step boundary for capture-and-replay
    (``HVD_STEP_CAPTURE``): call once per loop iteration, or use ``with
    hvd.step_marker():`` around the step. With the knob off it only
    closes an open region."""
    from . import fusion_cycle
    cap = fusion_cycle.scheduler().capture
    cap.boundary()
    return _Region(cap)


class _AutoRegion:
    """The region ``DistributedOptimizer`` wraps its bucket sync in: opened
    only when the knob is on and no user region is open, so a user's
    ``hvd.step_marker()`` spanning the whole step wins."""

    __slots__ = ("_cap",)

    def __init__(self):
        self._cap = None

    def __enter__(self):
        from . import fusion_cycle
        cap = fusion_cycle.scheduler().capture
        if cap.enabled() and not cap.region_open():
            self._cap = cap
            cap.boundary()
        return self

    def __exit__(self, *exc):
        if self._cap is not None:
            self._cap.boundary(closing=True)
            self._cap = None
        return False


def auto_region() -> _AutoRegion:
    return _AutoRegion()
