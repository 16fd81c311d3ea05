"""Timeline: Chrome-trace recording of eager collectives and negotiation
(port of ``horovod_tpu/timeline.py``).

The writer is the native engine's (``native/timeline.cc``: a writer thread
over a bounded queue, one lane per tensor name), bound through
``dynamic.NativeEngine``; this module owns the process's instance, the
``HVD_TIMELINE`` start at ``init()`` and the recording hooks:

* ``NEGOTIATE`` ranges from a request's submission to its plan
  (``engine_service.py``), served requests included;
* one range per eager collective (``ALLREDUCE``, ``GROUPED_ALLREDUCE``,
  ``ALLGATHER``, ``BROADCAST``, ``GROUPED_BROADCAST``, ``ALLTOALL``,
  ``REDUCESCATTER``) around its issue;
* on the ``optimizer`` lane, ranges at the gradient sync's boundaries
  (``optim/__init__.py``): ``BUCKET_START`` (a bucket's gather, enqueue
  and hand-off), ``SYNC_WAIT`` and ``SYNC_UNPACK`` (``synchronize()``'s
  wait for a bucket and its unpack into ``.grad``) and ``OPTIMIZER_STEP``
  (the wrapped optimizer's step);
* instants on the ``health`` lane (``RETRY``, ``PEER_DEAD``, ``POISON``,
  ``STRAGGLER``, ``RC_JOIN_RACE``) and, with ``HVD_TIMELINE_MARK_CYCLES``,
  a ``CYCLE`` instant per negotiation cycle;
* the fusion and plan machinery's, under the JAX package's names:
  ``QUEUE_ENQUEUE`` on a tensor's lane, ``CYCLE_FLUSH.<trigger>`` on the
  ``fusion_cycle`` lane, ``INFLIGHT_DEPTH.<n>`` and ``PIPELINE_<stage>``
  ranges on the ``pipeline`` lane (``ISSUE``: one flush's issue; ``PACK``:
  the wire buffers' packing; ``SLOT_WAIT``; ``DISPATCH``),
  ``QOS_<event>.<tenant>`` on the ``qos`` lane, ``CAPTURE_<event>``
  (``RECORD``, ``SEAL``, ``REPLAY``, ``REPLAY_DONE``, ``BYPASS``,
  ``FALLBACK``) on the ``step_capture`` lane and ``PLAN_HIT``/``PLAN_MISS``
  on an op's lane.

Every range is a :func:`span`: on the timeline while it is active, and a
``torch.profiler.record_function`` range named ``hvd.<activity>.<lane>``
while ``torch.profiler`` records the calling thread (the NVTX analog; the
profiler's state is per thread, so a thread it was not started from, such
as the flush executor's, records nothing there). With neither on, a span
costs two flag checks.

**Host clock, never the device's.** A timeline record takes the native
writer's steady clock, a profiler range the profiler's, and neither
synchronizes the card: an activity is the host-side range around the
*issue* of asynchronous NCCL work, not the work's device duration (which
a ``torch.profiler`` trace shows). The JAX package annotated
``jax.profiler`` traces the same way.

A world above one writes one file a process, ``<HVD_TIMELINE>.<rank>``;
:func:`merge_timelines` joins them into one trace, one pid a rank.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch._C._autograd import _profiler_enabled

from .utils import envs
from .utils import logging as hvd_logging

_lock = threading.Lock()
_engine = None  # the NativeEngine owning the writer
_active = False
_mark_cycles = False
_atexit_registered = False

NEGOTIATE = "NEGOTIATE"
HEALTH_LANE = "health"
RETRY = "RETRY"
PHASE_BEGIN = 0
PHASE_END = 1
PHASE_INSTANT = 2
QUEUE_ENQUEUE = "QUEUE_ENQUEUE"
CYCLE_FLUSH = "CYCLE_FLUSH"
PIPELINE_LANE = "pipeline"
OPTIMIZER_LANE = "optimizer"
INFLIGHT_DEPTH = "INFLIGHT_DEPTH"
QOS_LANE = "qos"
CAPTURE_LANE = "step_capture"


def _get_engine():
    global _engine
    if _engine is None:
        from .dynamic import NativeEngine
        _engine = NativeEngine(world_size=1, rank=0)
    return _engine


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Record to ``file_path`` (Chrome trace JSON, for ``chrome://tracing``
    or Perfetto): reference ``hvd.start_timeline``
    (``operations.cc:1032-1064``). With ``mark_cycles`` or
    ``HVD_TIMELINE_MARK_CYCLES`` every negotiation cycle drops an
    instant."""
    global _active, _atexit_registered, _mark_cycles
    with _lock:
        _get_engine().timeline_start(file_path)
        _active = True
        _mark_cycles = bool(mark_cycles) or envs.get_bool(
            envs.TIMELINE_MARK_CYCLES)
        if not _atexit_registered:
            import atexit
            atexit.register(stop_timeline)  # flushes at interpreter exit
            _atexit_registered = True


def stop_timeline() -> None:
    """Flush and close the file (reference ``hvd.stop_timeline``). The
    next :func:`start_timeline` gets a writer of its own, so its file names
    every lane again."""
    global _active, _engine
    with _lock:
        _active = False
        eng, _engine = _engine, None
        if eng is not None:
            eng.timeline_stop()


def timeline_active() -> bool:
    return _active


def mark_cycle() -> None:
    """A ``CYCLE`` instant on the ``negotiation`` lane, when cycles are
    marked (``HOROVOD_TIMELINE_MARK_CYCLES``)."""
    if _active and _mark_cycles:
        record("negotiation", "CYCLE", PHASE_INSTANT)


def maybe_autostart(rank: int, size: int) -> None:
    """Start the timeline where ``HVD_TIMELINE`` names a file (``DYNAMIC``
    waits for :func:`start_timeline`, as in the reference,
    ``operations.cc:466-488``); a world above one writes
    ``<path>.<rank>``. Called by ``runtime.init``; a file that cannot be
    opened is logged and does not stop training."""
    path = envs.get(envs.TIMELINE)
    if not path or path.upper() == "DYNAMIC" or _active:
        return
    if size > 1:
        path = f"{path}.{rank}"
    try:
        start_timeline(path)
    except Exception as e:  # an IO error or an engine that did not build
        hvd_logging.error("cannot start timeline at %s: %s", path, e)


def record(tensor: str, activity: str, phase: int) -> None:
    """One event on ``tensor``'s lane, when the timeline is active."""
    if not _active:
        return
    eng = _engine
    if eng is not None:
        eng.timeline_record(tensor, activity, phase)


def record_retry(what: str, attempt: int) -> None:
    """A ``RETRY.<site>.<n>`` instant on the ``health`` lane when a KV
    call backs off (``utils/retry.py``)."""
    if _active:
        record(HEALTH_LANE, f"{RETRY}.{what}.{int(attempt)}", PHASE_INSTANT)


def record_health_event(event: str) -> None:
    """An instant on the ``health`` lane (``PEER_DEAD.<rank>``, ``POISON``,
    ``STRAGGLER.<rank>``, ``RC_JOIN_RACE``)."""
    if _active:
        record(HEALTH_LANE, event, PHASE_INSTANT)


def record_dispatch(tensor: str, hit: bool) -> None:
    """A ``PLAN_HIT``/``PLAN_MISS`` instant on the op's lane
    (``ops/dispatch_cache.py``)."""
    if _active:
        record(tensor, "PLAN_HIT" if hit else "PLAN_MISS", PHASE_INSTANT)


def record_queue_enqueue(tensor: str) -> None:
    """A ``QUEUE_ENQUEUE`` instant on the tensor's lane when an async
    submission lands in a fusion-cycle queue."""
    if _active:
        record(tensor, QUEUE_ENQUEUE, PHASE_INSTANT)


def record_cycle_flush(trigger: str) -> None:
    """A ``CYCLE_FLUSH.<trigger>`` instant on the ``fusion_cycle`` lane,
    one a flush."""
    if _active:
        record("fusion_cycle", f"{CYCLE_FLUSH}.{trigger}", PHASE_INSTANT)


def record_inflight_depth(depth: int) -> None:
    """An ``INFLIGHT_DEPTH.<n>`` instant on the ``pipeline`` lane when the
    flush executor admits a batch: ``n`` earlier flushes were still
    incomplete on the device."""
    if _active:
        record(PIPELINE_LANE, f"{INFLIGHT_DEPTH}.{int(depth)}",
               PHASE_INSTANT)


def record_qos(event: str, tenant: str) -> None:
    """A ``QOS_<event>.<tenant>`` instant on the ``qos`` lane (``PARK``,
    ``GRANT``, ``FORCE``, ``SHED``, ``BLOCK``)."""
    if _active:
        record(QOS_LANE, f"QOS_{event}.{tenant}", PHASE_INSTANT)


def record_capture(event: str) -> None:
    """A ``CAPTURE_<event>`` instant on the ``step_capture`` lane."""
    if _active:
        record(CAPTURE_LANE, f"CAPTURE_{event}", PHASE_INSTANT)


def pipeline_stage(stage: str) -> "_Span | contextlib.nullcontext":
    """A ``PIPELINE_<stage>`` range on the ``pipeline`` lane (``ISSUE``: a
    flush's issue; ``PACK``: packing wire buffers; ``SLOT_WAIT``: the
    executor blocked on the device; ``DISPATCH``: a chunk's issue)."""
    return span(PIPELINE_LANE, f"PIPELINE_{stage}")


def merge_timelines(inputs, output: str) -> int:
    """Merge per-process timeline files into one Chrome trace, one pid a
    process: a file named ``<base>.<rank>`` takes its rank as pid, another
    its position in ``inputs``. Events are sorted by time and each pid gets
    a ``process_name`` record. Returns the number of events written. Also
    a command: ``python -m horovod_tpu_torch.timeline OUT.json IN.0 ...``."""
    import json
    import os
    import re

    events = []
    for i, path in enumerate(inputs):
        m = re.search(r"\.(\d+)$", os.path.basename(path))
        pid = int(m.group(1)) if m else i
        with open(path) as f:
            text = f.read().strip()
        # a file still being written lacks its closing bracket
        text = text.rstrip(",\n ")
        if not text.endswith("]"):
            text += "]"
        for ev in json.loads(text):
            ev["pid"] = pid
            events.append(ev)
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"rank {pid}"}})
    events.sort(key=lambda e: e.get("ts", 0))
    with open(output, "w") as f:
        json.dump(events, f)
    return len(events)


_NO_SPAN = contextlib.nullcontext()  # neither timeline nor profiler on


class _Span:
    __slots__ = ("lane", "activity", "_fn", "_recorded")

    def __init__(self, lane: str, activity: str, profiled: bool):
        self.lane = lane
        self.activity = activity
        self._fn = (torch.profiler.record_function(f"hvd.{activity}.{lane}")
                    if profiled else None)
        self._recorded = False

    def __enter__(self):
        if _active:
            record(self.lane, self.activity, PHASE_BEGIN)
            self._recorded = True
        if self._fn is not None:
            self._fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self._fn is not None:
            self._fn.__exit__(*exc)
        if self._recorded:
            record(self.lane, self.activity, PHASE_END)
        return False


def span(lane: str, activity: str) -> "_Span | contextlib.nullcontext":
    """A range of ``activity`` on ``lane``: begin and end records on the
    timeline while it is active, and a ``torch.profiler.record_function``
    range ``hvd.<activity>.<lane>`` (name, start and end on the profiler's
    clock, nested in the calling thread's open range) while the profiler
    records this thread. Neither touches the device; with both off it
    allocates nothing."""
    profiled = _profiler_enabled()
    if not (_active or profiled):
        return _NO_SPAN
    return _Span(lane, activity, profiled)


op_range = span  # the eager collectives' name for it


if __name__ == "__main__":
    import sys
    if len(sys.argv) < 3:
        print("usage: python -m horovod_tpu_torch.timeline OUT.json IN.0 "
              "[IN.1 ...]", file=sys.stderr)
        raise SystemExit(2)
    n = merge_timelines(sys.argv[2:], sys.argv[1])
    print(f"merged {len(sys.argv) - 2} timelines ({n} events) -> "
          f"{sys.argv[1]}")
