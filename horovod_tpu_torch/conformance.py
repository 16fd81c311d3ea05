"""Cross-rank lockstep conformance recorder (``HVD_CONFORMANCE``; port of
``horovod_tpu/conformance.py``).

The negotiation service rests on rank-deterministic decisions: every rank
confirms a coordinator ResponseCache entry, and serves a batch from it, at
the same point of its stream. One divergent decision shows as a hang at the
exchange deadline with nothing to say why. This recorder hooks each
decision point, chains each event's content hash into a per-stream crc
digest, and dumps one trace file a rank that the repository's stdlib-only
``python -m tools.hvdtrace`` diffs across ranks down to the first
divergent event. The trace schema, header and file names are the JAX
package's, so the tool reads either package's traces unchanged.

* ``lockstep`` events chain: every rank's chain of a stream must be equal.
  The response cache's confirm and serve flips, and the knob-override
  epoch moves, are lockstep.
* ``local`` events are recorded (and checked against the protocol's state
  machine offline) but not chained: the service's lifecycle and join, and
  the cache's warm restore, confirm and drop, may differ between ranks.

:data:`SITES` lists the port's decision points under the JAX package's
site names: the fusion flush composition, the QoS grant order, the step
capture's phases, the response cache, the plan cache's builds and the
service's lifecycle (the JAX package's elastic checkpoint sites have no
producer here yet). A process is a rank, so there is one recorder a
process, labelled ``rank<N>`` by its launcher rank.

With ``HVD_CONFORMANCE`` unset, :func:`record` is one cached bool read.
Hashing is ``zlib.crc32`` over ``repr``: no clock, no randomness.
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import zlib

from .utils import envs

__all__ = [
    "LOCKSTEP", "LOCAL", "SITES", "STREAMS", "TRACE_SCHEMA", "Recorder",
    "record", "enabled", "refresh", "set_enabled", "conformance_dump",
    "conformance_stats", "maybe_dump", "reset",
]

TRACE_SCHEMA = 1

LOCKSTEP = "lockstep"
LOCAL = "local"

# site ("<module>.py::<qualname>", relative to the package) -> (stream,
# event class); the reference's keys for the same decisions
SITES = {
    # the fusion flush composition
    "ops/fusion_cycle.py::FusionScheduler.flush_queue":
        ("flush", LOCKSTEP),
    # the QoS arbiter's grant order
    "qos.py::QosGate._grant_locked": ("qos", LOCKSTEP),
    # step-capture phase moves, seal keys and replay completion
    "ops/step_capture.py::CaptureState.boundary": ("capture", LOCKSTEP),
    "ops/step_capture.py::CaptureState._seal_locked":
        ("capture", LOCKSTEP),
    "ops/step_capture.py::CaptureState._diverge_locked":
        ("capture", LOCKSTEP),
    "ops/step_capture.py::CaptureState._execute_replay":
        ("capture", LOCKSTEP),
    # response-cache confirm flips and serve decisions
    "negotiation/response_cache.py::ResponseCache.note_response":
        ("rcache", LOCKSTEP),
    "negotiation/response_cache.py::ResponseCache.count_served":
        ("rcache", LOCKSTEP),
    # the warm-entry machinery: rank-asymmetric by design
    "negotiation/response_cache.py::ResponseCache.restore_warm":
        ("rcache", LOCAL),
    "negotiation/response_cache.py::ResponseCache.confirm_warm":
        ("rcache", LOCAL),
    "negotiation/response_cache.py::ResponseCache.drop_warm":
        ("rcache", LOCAL),
    # the negotiation service's lifecycle and join
    "engine_service.py::DynamicService.__init__": ("service", LOCAL),
    "engine_service.py::DynamicService.stop": ("service", LOCAL),
    "engine_service.py::DynamicService._on_peer_failure":
        ("service", LOCAL),
    "engine_service.py::DynamicService.join": ("service", LOCAL),
    # dispatch plan builds, and the shelf of an elastic re-form: a plan
    # cache is a process's own
    "ops/dispatch_cache.py::store": ("plans", LOCAL),
    "ops/dispatch_cache.py::shelve_for_reform": ("plans", LOCAL),
    "ops/dispatch_cache.py::restore_for_reform": ("plans", LOCAL),
    "ops/dispatch_cache.py::_warm_graft_locked": ("plans", LOCAL),
}

_EPOCH_STREAM = "epoch"  # knob-override epoch moves, fed by the recorder
STREAMS = ("flush", "qos", "capture", "rcache", "plans", "service",
           _EPOCH_STREAM)

_force_enabled: bool | None = None  # a test's override; None: the knob


def _read_enabled() -> bool:
    if _force_enabled is not None:
        return _force_enabled
    return envs.conformance_enabled()


_enabled = _read_enabled()


def enabled() -> bool:
    """Whether decision points record (``HVD_CONFORMANCE``, default
    off)."""
    return _enabled


def refresh() -> None:
    """Read ``HVD_CONFORMANCE`` again."""
    global _enabled
    _enabled = _read_enabled()


def set_enabled(value: bool | None) -> None:
    """Force recording on or off; ``None`` goes back to the knob."""
    global _force_enabled
    _force_enabled = value
    refresh()


def _crc(prev: int, *parts) -> int:
    return zlib.crc32(repr(parts).encode(), prev) & 0xFFFFFFFF


def _env_int(*names) -> int:
    for name in names:
        val = os.environ.get(name)
        if val is not None:
            try:
                return int(val)
            except ValueError:
                pass
    return -1


class Recorder:
    """One process's event log: per-stream digest chains, the compact
    per-event index and the bounded ring of full payloads."""

    __slots__ = ("header", "chains", "events", "ring", "seq",
                 "dump_count", "_epoch", "_mu")

    def __init__(self):
        rank = envs.launcher_rank()
        env = os.environ
        self.header = {
            "schema": TRACE_SCHEMA,
            "label": "proc" if rank is None else f"rank{rank}",
            "rank": -1 if rank is None else rank,
            "size": _env_int("HVD_SIZE", "WORLD_SIZE"),
            # the rendezvous coordinates group the traces of one world
            "world": env.get("HVD_COORDINATOR_ADDR",
                             env.get("MASTER_ADDR", "")),
            "round": env.get("HVD_COORDINATOR_PORT",
                             env.get("MASTER_PORT", "")),
            "elastic_round": "",
            "generation": 0,
        }
        self.chains = {s: 0 for s in STREAMS}
        # [seq, stream, cls, site, kind, crc]: crc is the stream's chain
        # after the event (lockstep) or the event's own (local)
        self.events: list[list] = []
        self.ring = collections.deque(maxlen=envs.conformance_ring())
        self.seq = 0
        self.dump_count = 0
        self._epoch = envs.override_epoch()
        self._mu = threading.Lock()

    def note(self, site: str, kind: str, payload) -> None:
        stream, cls = SITES.get(site, ("service", LOCAL))
        with self._mu:
            epoch = envs.override_epoch()
            if epoch != self._epoch:
                self._note_locked(_EPOCH_STREAM, LOCKSTEP,
                                  "conformance.py::Recorder.note", "epoch",
                                  (self._epoch, epoch))
                self._epoch = epoch
            self._note_locked(stream, cls, site, kind, payload)

    def _note_locked(self, stream: str, cls: str, site: str, kind: str,
                     payload) -> None:
        seq = self.seq
        self.seq = seq + 1
        if cls == LOCKSTEP:
            crc = _crc(self.chains[stream], kind, payload)
            self.chains[stream] = crc
        else:
            crc = _crc(0, kind, payload)
        self.events.append([seq, stream, cls, site, kind, crc])
        if self.ring.maxlen:
            self.ring.append([seq, site, kind, repr(payload)])

    def trace(self) -> dict:
        """The trace document ``tools/hvdtrace`` reads."""
        with self._mu:
            return {**self.header, "chains": dict(self.chains),
                    "events": [list(e) for e in self.events],
                    "ring": [list(r) for r in self.ring],
                    "n_events": self.seq}

    def stats(self) -> dict:
        with self._mu:
            per_stream = {s: 0 for s in STREAMS}
            for event in self.events:
                per_stream[event[1]] += 1
            return {"enabled": _enabled, "label": self.header["label"],
                    "events": self.seq, "by_stream": per_stream,
                    "chains": dict(self.chains), "ring": len(self.ring)}


_recorder_obj: Recorder | None = None
_reg_mu = threading.Lock()


def _recorder() -> Recorder:
    global _recorder_obj
    with _reg_mu:
        if _recorder_obj is None:
            _recorder_obj = Recorder()
        return _recorder_obj


def record(site: str, kind: str, payload) -> None:
    """Record one decision at a :data:`SITES` ``site``; nothing when
    off."""
    if _enabled:
        _recorder().note(site, kind, payload)


def _trace_filename(header: dict, dump_count: int) -> str:
    raw = "hvdtrace-{}-r{}-g{}-{}".format(
        header.get("world") or "world", header.get("round") or "0",
        header.get("generation") or 0, header.get("label") or "proc")
    if dump_count:
        raw += f"-d{dump_count}"
    return re.sub(r"[^A-Za-z0-9._-]+", "_", raw) + ".json"


def _write(doc: dict, target: str) -> None:
    os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
    with open(target, "w") as f:
        json.dump(doc, f)


def conformance_dump(path: str | None = None) -> dict:
    """This process's trace (``hvd.conformance_dump()``), written to
    ``path``, else into ``HVD_CONFORMANCE_DIR`` where that is set; returns
    the document."""
    rec = _recorder()
    doc = rec.trace()
    target = path
    if target is None and envs.conformance_dir():
        target = os.path.join(envs.conformance_dir(),
                              _trace_filename(doc, rec.dump_count))
    if target is not None:
        _write(doc, target)
        doc["path"] = target
    return doc


def maybe_dump(reason: str) -> str | None:
    """At shutdown: write the trace into ``HVD_CONFORMANCE_DIR`` when
    recording is on, that knob is set and an event was recorded; returns
    the path. Never raises: a failed write must not mask the teardown."""
    with _reg_mu:
        rec = _recorder_obj
    if not _enabled or rec is None or rec.seq == 0:
        return None
    d = envs.conformance_dir()
    if not d:
        return None
    try:
        doc = rec.trace()
        doc["dump_reason"] = reason
        target = os.path.join(d, _trace_filename(doc, rec.dump_count))
        rec.dump_count += 1
        _write(doc, target)
        return target
    except OSError:
        from .utils import logging as hvd_logging
        hvd_logging.exception("conformance trace dump failed (%s)", reason)
        return None


def conformance_stats() -> dict:
    """The recorder's counters (``hvd.conformance_stats()``)."""
    with _reg_mu:
        rec = _recorder_obj
    if rec is None:
        return {"enabled": _enabled, "events": 0, "by_stream": {},
                "chains": {}, "ring": 0, "label": ""}
    return rec.stats()


def reset() -> None:
    """Drop the recorder: the next event starts a fresh trace."""
    global _recorder_obj
    with _reg_mu:
        _recorder_obj = None
