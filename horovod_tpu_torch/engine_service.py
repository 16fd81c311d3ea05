"""Negotiation service of multi-process eager collectives (port of
``horovod_tpu/engine_service.py``).

The reference's background loop (``BackgroundThreadLoop`` -> ``RunLoopOnce``
every ``CycleTimeMs``, ``operations.cc:385-806``): each process ticks the
symmetric negotiation protocol of :mod:`horovod_tpu_torch.dynamic` over the
launcher's KV store (``runner/http_kv.py``). A process is a rank. Eager
collectives negotiate before they issue, and the service guarantees that

* every rank issues the negotiated collectives in one agreed order: the
  order in which their plans arrive, the same on every rank;
* a disagreement of shape, dtype, op or root is a
  :class:`~horovod_tpu_torch.dynamic.HorovodCollectiveError` on every rank,
  raised before any collective is issued, instead of a hang;
* a tensor submitted by some ranks but not all is reported by the stall
  inspector after ``HVD_STALL_CHECK_TIME_SECONDS`` (60 s by default);
* ``join()`` lets a rank with no data left contribute zeros to the
  allreduces, zero rows to the allgathers and its arrival to the barriers
  that the others still run.

The cycle thread exchanges and delivers plans; it issues no collective,
except the zero contributions of a joined rank, while that rank's own
thread is blocked inside ``join()``. Every other collective is issued by
the thread that asks for it, in the agreed order (:meth:`DynamicService.
run_until`): a collective whose plan has arrived is issued once every
collective whose plan arrived before it has been.

**The coordinator ResponseCache** (``negotiation/response_cache.py``,
``HVD_RESPONSE_CACHE``) answers a steady-state request with no round once
a real round has proven that every rank holds its response. A served
collective has no plan, so it has no place in the delivery order; its
place is this rank's **submission order**: it is issued after every
collective submitted before it on this rank, and before every collective
submitted after it. Between two served collectives, the negotiated ones
keep the delivery order. Every rank computes the same places, because a
cache entry is confirmed on every rank at the same negotiation index
(the AND-ed cache bits), so a name is served from the same occurrence on
every rank, and steady-state traffic that is served is submitted in
program order (docs/negotiation.md:99-125). Taking the delivery counter
at submission instead would let two ranks put a served collective on
either side of a plan that arrives meanwhile: two issue orders on one
communicator, a hang or a wrong pairing.

Past one leader group (``HVD_NEGOTIATION_GROUP_SIZE``, 8) a round runs
member -> leader -> cross-leader -> fan-down (``negotiation/
hierarchy.py``). A health watchdog (``health.py``) beats over the same KV
store: a dead peer fails every waiter with :class:`PeerFailureError`
within ``HVD_HEALTH_TIMEOUT`` seconds instead of the 600 s exchange
deadline. Rounds feed the metrics registry and the straggler tracker,
requests draw ``NEGOTIATE`` ranges on the timeline, and the service's
lifecycle, join and cache decisions go to the conformance recorder.

The service starts where a launcher's KV store is set (``HVD_KV_ADDR``,
``HVD_KV_PORT``, ``HVD_SECRET_KEY``) in a world of more than one rank, one
service per process set over its members; ``HVD_DYNAMIC_ENGINE=0`` turns it
off. The engine must build: there is no quiet fallback to running
unnegotiated.
"""

from __future__ import annotations

import os
import struct
import threading
import time

import torch

from . import conformance as _conformance
from . import health as _health
from . import metrics as _metrics
from . import runtime
from . import timeline as _timeline
from .dynamic import (REQ_ALLTOALL, REQ_BROADCAST, REQ_JOIN,
                      REQ_REDUCESCATTER, RESP_ERROR, DuplicateNameError,
                      HorovodCollectiveError, NativeEngine, Response,
                      and_bitvectors, parse_requests)
from .exceptions import PeerFailureError, ResponseCacheJoinError
from .negotiation import response_cache as _rcache
from .negotiation.hierarchy import HierarchicalTransport
from .utils import envs
from .utils import invariants as _inv
from .utils import faults as _faults
from .utils import logging as hvd_logging

# The idle cycle over the HTTP KV transport: a KV round costs milliseconds,
# so ticking faster burns CPU. Work in flight wakes the loop at once and
# lowers the pace to DEFAULT_PENDING_CYCLE_TIME_MS (HVD_ADAPTIVE_CYCLE=0
# keeps the fixed cadence).
DEFAULT_KV_CYCLE_TIME_MS = 20.0
DEFAULT_PENDING_CYCLE_TIME_MS = 2.0
_STALL_CHECK_INTERVAL_S = 5.0
EXCHANGE_TIMEOUT_S = 600.0  # a peer silent this long has failed
# no collective sound with zero contribution (docs/join.md)
_NOT_JOINABLE = (REQ_BROADCAST, REQ_ALLTOALL, REQ_REDUCESCATTER)


class KVTransport:
    """Allgather of each member's (requests, cache bits) frame over the KV
    store: one PUT and one long-poll gather per member and cycle (the
    analog of the reference controller's MPI gather and broadcast)."""

    def __init__(self, kv_client, world_size: int, rank: int,
                 prefix: str = "engine"):
        self.kv = kv_client
        self.world_size = world_size
        self.rank = rank
        self.prefix = prefix
        self.last_round_s = 0.0  # the last exchange, publish to gathered
        # each member's lag behind the round's first submitter, on the KV
        # server's clock (skew between hosts cannot fake a straggler)
        self.last_lags: dict[int, float] = {}

    def exchange(self, cycle: int, req_bytes: bytes, bits: bytes,
                 timeout: float) -> tuple[list[bytes], list[bytes]]:
        """One round: publish (requests, bits), collect everyone's. A
        member silent for ``timeout`` raises :class:`PeerFailureError`."""
        _faults.inject("svc.exchange")
        t0 = time.monotonic()
        frame = struct.pack("<I", len(req_bytes)) + req_bytes + bits
        scope = f"{self.prefix}/x/{cycle}"
        self.kv.put(f"{scope}/{self.rank}", frame)
        try:
            got, times = self.kv.gather(scope, self.world_size,
                                        timeout=timeout, with_times=True)
        except TimeoutError as e:
            seen = {int(k.rsplit("/", 1)[1]) for k in self.kv.keys(scope)}
            missing = [r for r in range(self.world_size) if r not in seen]
            raise PeerFailureError(missing[0] if missing else -1,
                                   f"no negotiation frame: {e}") from e
        self.last_round_s = time.monotonic() - t0
        datas: list = [b""] * self.world_size
        bitvs: list = [b""] * self.world_size
        for k, v in got.items():
            r = int(k.rsplit("/", 1)[1])
            (ln,) = struct.unpack_from("<I", v, 0)
            datas[r] = v[4:4 + ln]
            bitvs[r] = v[4 + ln:]
        receipt = {int(k.rsplit("/", 1)[1]): t for k, t in times.items()}
        first = min(receipt.values()) if receipt else 0.0
        self.last_lags = {r: t - first for r, t in sorted(receipt.items())}
        # every member read cycle c before any can write cycle c + 2, so
        # our cycle c - 1 key is no longer read
        if cycle > 0:
            self.kv.delete(f"{self.prefix}/x/{cycle - 1}/{self.rank}")
        return datas, bitvs


class _Pending:
    __slots__ = ("event", "response", "order")

    def __init__(self):
        self.event = threading.Event()
        self.response: Response | None = None
        self.order = -1  # the place of its plan in the agreed order


class NegotiationTicket:
    """An in-flight :meth:`DynamicService.negotiate_many_submit`, consumed
    by exactly one of ``negotiate_many_wait`` and
    ``negotiate_many_cancel``. ``served``: the coordinator ResponseCache
    answered the whole batch at submission; no round is in flight and
    its names were never registered."""

    __slots__ = ("requests", "pends", "submitted_at", "served")

    def __init__(self, requests, pends, served: bool = False):
        self.requests = requests
        self.pends = pends
        self.submitted_at = time.monotonic()
        self.served = served

    def ready(self) -> bool:
        return all(p.event.is_set() for p in self.pends)

    def order(self) -> int:
        return max(p.order for p in self.pends)


class Queued:
    """A negotiated collective: its ticket, ``issue(responses)`` that
    issues it, and once issued its ``result`` or ``error``."""

    __slots__ = ("ticket", "issue", "issued", "result", "error")

    def __init__(self, ticket, issue):
        self.ticket, self.issue = ticket, issue
        self.issued, self.result, self.error = False, None, None


class DynamicService:
    """One engine and transport, cycled on a background thread.
    ``global_ranks`` maps the transport's member indices to global ranks
    (default: the identity); ``pset_key`` labels the service's metrics and
    conformance events."""

    def __init__(self, engine: NativeEngine, transport, device=None,
                 global_ranks=None, pset_key: str = "global"):
        self.engine = engine
        self.transport = transport
        self.pset_key = pset_key
        world = getattr(transport, "world_size", 1)
        _conformance.record(
            "engine_service.py::DynamicService.__init__", "svc_start",
            (pset_key, world, getattr(transport, "rank", 0)))
        # idle cadence scales with the world: every member exchanges every
        # tick, so a large world would flood the one KV server
        self._idle_cycle_default_ms = (
            DEFAULT_KV_CYCLE_TIME_MS * max(1.0, world / 16.0))
        self.rounds = 0  # busy rounds, and their summed seconds
        self.round_seconds = 0.0
        self.step_negotiations = 0  # negotiate_step calls
        self._device = device
        # the coordinator ResponseCache: on by default past one leader
        # group (HVD_RESPONSE_CACHE); an override epoch move flips, resizes
        # or empties it (_rc_refresh_epoch)
        cap = envs.response_cache_capacity(world)
        self._rcache = (_rcache.ResponseCache(cap, pset_key)
                        if cap > 0 else None)
        self._rc_epoch = envs.override_epoch()
        # batches served since the last cycle: the window in which a serve
        # can race a peer's JOIN (_check_join_race)
        self._rc_serves_window = 0
        # set once a JOIN is seen: a joined rank learns of the collectives
        # it owes zeros to from real rounds only, so serving ends for good
        self._rc_join_latch = False
        # the elastic warm re-form: adopt the shelved entries of a
        # predecessor of the same shape as warm (not servable), publish
        # this rank's digest of them, and resolve at the first cycle: equal
        # digests on every member confirm them after one round; any other
        # answer (a fresh member publishes the empty digest) drops them
        self._rc_warm_pending = False
        self._rc_shape_key = ("proc", pset_key, world,
                              getattr(transport, "rank", 0))
        if (self._rcache is not None and envs.elastic_warm_enabled()
                and getattr(transport, "kv", None) is not None
                and getattr(transport, "prefix", None) is not None):
            shelved = _rcache.take_shelved(self._rc_shape_key)
            if shelved:
                n = self._rcache.restore_warm(shelved)
                hvd_logging.info(
                    "response cache: restored %d warm entries for shape "
                    "%s", n, self._rc_shape_key)
            try:
                # every member publishes (an empty digest is the veto);
                # only a member holding warm entries gathers
                transport.kv.put(f"{transport.prefix}/warm/{transport.rank}",
                                 self._rcache.warm_digest())
                self._rc_warm_pending = self._rcache.warm_count() > 0
            except Exception as e:
                hvd_logging.warning(
                    "response cache: warm digest publish failed (%s); "
                    "cold re-form", e)
                self._rcache.drop_warm()
        self._cycle = 0
        self._delivered = 0  # plans delivered: the agreed order
        self._mu = threading.Lock()
        self._pending: dict[str, _Pending] = {}
        self._queue: list[Queued] = []  # submitted, not yet issued
        self._issue_lock = threading.RLock()
        self._joined = False
        self._failure: str | None = None
        self._failure_exc: Exception | None = None
        self._shutdown = threading.Event()
        self._tick = threading.Event()  # fresh work: skip the cycle sleep
        self._last_stall_check = time.monotonic()
        # liveness over the transport's KV store: a dead peer fails every
        # waiter within HVD_HEALTH_TIMEOUT (in-memory transports have none)
        self._watchdog: _health.HealthWatchdog | None = None
        kv = getattr(transport, "kv", None)
        if kv is not None and _health.enabled() and world > 1:
            self._watchdog = _health.HealthWatchdog(
                kv, world, transport.rank,
                prefix=f"{getattr(transport, 'prefix', 'engine')}/health",
                on_failure=self._on_peer_failure, global_ranks=global_ranks,
                layout=getattr(transport, "group_layout", None))
            self._watchdog.start()
        self._straggler = _health.StragglerTracker(
            getattr(transport, "rank", 0),
            (list(global_ranks) if global_ranks is not None
             else list(range(world))))
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-engine-cycle")
        self._thread.start()

    # -- public ------------------------------------------------------------

    def negotiate(self, name: str, request_type: int, *,
                  timeout: float | None = None, **meta) -> Response:
        """Enqueue one request and block until the plan includes it."""
        return self.negotiate_many([dict(name=name,
                                         request_type=request_type, **meta)],
                                   timeout=timeout)[0]

    def join(self, name: str, timeout: float | None = None) -> int:
        """Reference ``hvd.join`` (``operations.cc:1729-1761``): this rank
        stops contributing data; until every rank has joined, the cycle
        thread runs the collectives the others schedule with zero inputs.
        Returns the last rank to join. Blocks without a deadline by
        default, as the reference does. Ends local serving for good."""
        self._joined = True
        self._rc_join_latch = True
        _conformance.record("engine_service.py::DynamicService.join",
                            "join", (self.pset_key, name))
        try:
            resp = self.negotiate(name, REQ_JOIN, timeout=float("inf")
                                  if timeout is None else timeout)
        finally:
            self._joined = False
        return resp.root_rank

    def negotiate_many(self, requests: list[dict],
                       timeout: float | None = None) -> list[Response]:
        """Enqueue a batch (one grouped op) and wait for all its plans."""
        return self.negotiate_many_wait(self.negotiate_many_submit(requests),
                                        timeout=timeout)

    def negotiate_step(self, requests: list[dict],
                       timeout: float | None = None) -> list[Response]:
        """One round for a whole step's requests (reference
        ``negotiate_step``): submitted together at one point of the
        program, they land in one cycle."""
        self.step_negotiations += 1
        return self.negotiate_many(requests, timeout=timeout)

    def negotiate_many_submit(self, requests: list[dict]) -> NegotiationTicket:
        """Register and enqueue a batch, waking the cycle loop, without
        waiting: no HTTP round is made in the caller's thread. A batch the
        ResponseCache answers whole comes back served."""
        _faults.inject("svc.submit")
        served = self._try_serve_cached(requests)
        if served is not None:
            return served
        pends = []
        with self._mu:
            if self._failure:
                raise self._failure_error()
            for req in requests:
                if req["name"] in self._pending:
                    raise DuplicateNameError(
                        f"tensor name {req['name']!r} is already being "
                        "negotiated; pass a unique name=")
            for req in requests:
                pend = _Pending()
                self._pending[req["name"]] = pend
                pends.append(pend)
                meta = {k: v for k, v in req.items()
                        if k not in ("name", "request_type")}
                try:
                    self.engine.enqueue(req["name"], req["request_type"],
                                        **meta)
                except Exception:
                    # roll back the batch's enqueued members; the failing
                    # one was not enqueued
                    self._pending.pop(req["name"], None)
                    for done in requests[:len(pends) - 1]:
                        self._pending.pop(done["name"], None)
                        self.engine.abandon(done["name"])
                    raise
        self._tick.set()
        for req in requests:
            _timeline.record(req["name"], _timeline.NEGOTIATE,
                             _timeline.PHASE_BEGIN)
        return NegotiationTicket(requests, pends)

    def negotiate_many_wait(self, ticket: NegotiationTicket,
                            timeout: float | None = None) -> list[Response]:
        """Block until every plan of the ticket has arrived (the timeout
        counts from submission); raise on an error plan. The responses of
        a real round feed the ResponseCache."""
        requests, pends = ticket.requests, ticket.pends
        deadline = timeout if timeout is not None else EXCHANGE_TIMEOUT_S
        end = ticket.submitted_at + deadline
        timed_out = False
        try:
            for req, pend in zip(requests, pends):
                if deadline == float("inf"):  # join: block as the reference
                    while not pend.event.wait(60.0):
                        if self._failure:
                            break
                    continue
                remaining = end - time.monotonic()
                if not pend.event.is_set() and (
                        remaining <= 0 or not pend.event.wait(remaining)):
                    timed_out = True
                    undelivered = sorted(r["name"] for r, p in
                                         zip(requests, pends)
                                         if p.response is None)
                    liveness = (self._watchdog.describe_peers()
                                if self._watchdog is not None
                                else "health watchdog off")
                    raise HorovodCollectiveError(
                        f"negotiation of {req['name']!r} timed out after "
                        f"{deadline}s (some processes never submitted it). "
                        f"Undelivered tensors: {undelivered}; peer "
                        f"liveness: {liveness}")
        finally:
            if not ticket.served:
                # a served ticket registered nothing: popping its names
                # would orphan a real negotiation of the same name
                with self._mu:
                    for req, pend in zip(requests, pends):
                        self._pending.pop(req["name"], None)
                        if pend.response is None:
                            _timeline.record(req["name"],
                                             _timeline.NEGOTIATE,
                                             _timeline.PHASE_END)
                            # a timed-out name leaves the engine too, so
                            # that it can be submitted again
                            if timed_out:
                                self.engine.abandon(req["name"])
        out = []
        for req, pend in zip(requests, pends):
            resp = pend.response
            if resp is None:
                if self._failure:
                    raise self._failure_error()
                raise HorovodCollectiveError(
                    f"negotiation of {req['name']!r} aborted")
            if resp.is_error:
                raise HorovodCollectiveError(resp.error_message)
            if self._rcache is not None and not ticket.served:
                # fed by real rounds only: a from_cache response confirms
                # the entry on every rank at this same occurrence
                self._rcache.note_response(req, resp)
            out.append(resp)
        return out

    def negotiate_many_cancel(self, ticket: NegotiationTicket) -> None:
        """Release a ticket that will not be waited for: its names leave
        the pending table and the engine, so they can be used again."""
        if ticket.served:
            return  # nothing registered, nothing in the engine
        with self._mu:
            for req, pend in zip(ticket.requests, ticket.pends):
                self._pending.pop(req["name"], None)
                if pend.response is None:
                    _timeline.record(req["name"], _timeline.NEGOTIATE,
                                     _timeline.PHASE_END)
                    self.engine.abandon(req["name"])

    def submit(self, requests: list[dict], issue) -> Queued:
        """Negotiate ``requests`` and queue ``issue(responses)``, which
        issues their collective, for :meth:`run_until`."""
        item = Queued(self.negotiate_many_submit(requests), issue)
        with self._issue_lock:
            self._queue.append(item)
        return item

    def submit_step(self, requests: list[dict], issue) -> Queued:
        """:meth:`submit` of a whole captured step's requests: one round
        (reference ``negotiate_step``), counted in ``step_negotiations``."""
        self.step_negotiations += 1
        return self.submit(requests, issue)

    def cancel(self, item: Queued) -> None:
        """Drop a queued collective that will not be issued (an aborted
        flush): it leaves the queue and its names the engine."""
        with self._issue_lock:
            if item in self._queue:
                self._queue.remove(item)
            item.issued = True
            item.error = RuntimeError("queued collective cancelled")
        self.negotiate_many_cancel(item.ticket)

    def run_until(self, item: Queued | None = None,
                  block: bool = True) -> None:
        """Issue queued collectives in the agreed order: with ``item``,
        those that come before it and ``item`` itself (waiting for plans
        when ``block``), else every one whose turn has come (with
        ``block``, every queued one). Raises ``item``'s error.

        The order: the queue splits at its served collectives into
        segments of submission order. A segment's negotiated collectives
        are issued in the order of their plans' arrival, the same on every
        rank; the served collective after a segment is issued once the
        segment is, and before the next segment. An issue made here is
        already in the agreed order: it takes the issue lock of
        ``ops/program_issue.py`` without waiting for the fusion cycle's
        executor, which may itself be waiting for this lock."""
        with self._issue_lock, _inv.section("svc-issue"):
            while item is None or not item.issued:
                head: list[Queued] = []
                fence = None
                for q in self._queue:
                    if q.ticket.served:
                        fence = q
                        break
                    head.append(q)
                if not head and fence is None:
                    break
                target = item is not None and any(q is item for q in head)
                if block:
                    for q in ([item] if target else head):
                        if not q.issued:
                            self._wait_plans(q)
                ready = sorted((q for q in head if not q.issued
                                and q.ticket.ready()),
                               key=lambda q: q.ticket.order())
                limit = (item.ticket.order() if target and not item.issued
                         and item.ticket.ready() else None)
                for q in ready:
                    if limit is not None and q.ticket.order() > limit:
                        break
                    self._issue(q)
                if (item is not None and item.issued) or any(
                        not q.issued for q in head) or fence is None:
                    break
                self._issue(fence)
        if item is not None and item.error is not None:
            raise item.error

    def _issue(self, q: Queued) -> None:
        self._queue.remove(q)
        q.issued = True
        try:
            q.result = q.issue(self.negotiate_many_wait(q.ticket))
        except Exception as e:  # the error of q's owner, not ours
            q.error = e

    def _wait_plans(self, q: Queued) -> None:
        """Wait for ``q``'s plans; a timeout or a failure is its error,
        and it leaves the queue."""
        for pend in q.ticket.pends:
            end = q.ticket.submitted_at + EXCHANGE_TIMEOUT_S
            if not pend.event.wait(max(end - time.monotonic(), 0.0)):
                break
        if q.ticket.ready():
            return
        self._queue.remove(q)
        q.issued = True
        try:
            self.negotiate_many_wait(q.ticket, timeout=0.0)
        except Exception as e:
            q.error = e

    def _shelve_rcache(self) -> None:
        """Shelve the coordinator cache's entries under this service's
        shape, for the service of a re-formed world of the same shape."""
        if (self._rcache is not None and self._failure is None
                and envs.elastic_warm_enabled()):
            items = self._rcache.export_entries()
            if items:
                _rcache.shelve(self._rc_shape_key, items)

    def stop(self):
        _conformance.record("engine_service.py::DynamicService.stop",
                            "svc_stop", (self.pset_key,))
        # a service stopped on purpose (a re-form's teardown, the job's
        # end) shelves its cache; one failed by a peer's death already
        # invalidated it: a broken world's proof does not carry over
        self._shelve_rcache()
        self._shutdown.set()
        self._tick.set()  # the adaptive sleep waits on _tick
        if self._watchdog is not None:
            # a departure on purpose: the marker goes out before the beats
            # cease, so a peer still watching reads no death
            self._watchdog.mark_leaving()
            self._watchdog.stop()
        # a cycle thread parked in the gather long-poll may take the
        # server's wait to notice; it is a daemon, and _fail_all settles
        # every waiter
        self._thread.join(timeout=2)
        self._fail_all("engine service stopped")

    def response_cache_stats(self) -> dict | None:
        """This service's ResponseCache counters, or None where
        ``HVD_RESPONSE_CACHE`` is off."""
        return self._rcache.stats() if self._rcache is not None else None

    def straggler_stats(self) -> dict:
        """This service's straggler tracker (``health.StragglerTracker``)."""
        return self._straggler.stats()

    # -- the coordinator ResponseCache -------------------------------------

    def _rc_refresh_epoch(self) -> None:
        """At a knob-override epoch move, re-read ``HVD_RESPONSE_CACHE``:
        the cache may turn on (cold), off (every entry drops) or change
        size, and a cache that stays is emptied."""
        epoch = envs.override_epoch()
        if epoch == self._rc_epoch:
            return
        self._rc_epoch = epoch
        cap = envs.response_cache_capacity(
            getattr(self.transport, "world_size", 1))
        rc = self._rcache
        if cap <= 0:
            if rc is not None:
                rc.invalidate("knob override epoch: cache disabled")
                self._rcache = None
            return
        if rc is None or rc.capacity != cap:
            self._rcache = _rcache.ResponseCache(cap, self.pset_key)
        else:
            rc.invalidate("knob override epoch")

    def _try_serve_cached(self, requests) -> NegotiationTicket | None:
        """The whole batch answered from the ResponseCache, or None for a
        real round (all or nothing, so a batch keeps its one round).
        Serving needs every entry confirmed, still in the native cache (a
        peer's changed metadata drops it there on every rank in the same
        cycle), and no JOIN seen."""
        self._rc_refresh_epoch()
        rc = self._rcache
        if rc is None or not requests:
            return None
        if (self._rc_join_latch or self._joined
                or self.engine.join_pending()):
            self._rc_join_latch = True
            return None
        responses = []
        for req in requests:
            resp = rc.lookup_confirmed(req)
            if resp is None or not self.engine.cache_has(req["name"]):
                rc.count_missed(sum(
                    1 for r in requests if _rcache.cacheable(r)))
                return None
            responses.append(resp)
        with self._mu:
            if self._failure:
                raise self._failure_error()
            # the latch again, under the lock the cycle thread sets it
            # under: a serve racing it is either stopped here or counted
            # in the window _check_join_race reads
            if self._rc_join_latch:
                return None
            for req in requests:
                if req["name"] in self._pending:
                    raise DuplicateNameError(
                        f"tensor name {req['name']!r} is already being "
                        "negotiated; pass a unique name=")
            self._rc_serves_window += 1
        pends = []
        for resp in responses:
            pend = _Pending()
            pend.response = resp
            pend.event.set()
            pends.append(pend)
        rc.count_served(len(requests))
        for req in requests:
            _timeline.record(req["name"], _timeline.NEGOTIATE,
                             _timeline.PHASE_BEGIN)
            _timeline.record(req["name"], _timeline.NEGOTIATE,
                             _timeline.PHASE_END)
        return NegotiationTicket(requests, pends, served=True)

    def _check_join_race(self, datas) -> None:
        """The cycle that first sees a peer's JOIN latches serving off. A
        batch served since the last cycle was decided without knowing of
        the join and was never scheduled through a round, so the joined
        rank can never pair it: fail now with a
        :class:`ResponseCacheJoinError` naming the joining rank, instead
        of hanging to the exchange deadline."""
        if self._rcache is None or self._rc_join_latch:
            return
        joiner = -1
        for data in datas:
            if not data:
                continue
            try:
                reqs = parse_requests(data)
            except Exception:  # a corrupt frame: ingest raises the error
                continue
            joiner = next((r["rank"] for r in reqs
                           if r["request_type"] == REQ_JOIN), -1)
            if joiner >= 0:
                break
        with self._mu:
            served = self._rc_serves_window
            self._rc_serves_window = 0
            if joiner >= 0:
                self._rc_join_latch = True
        if joiner >= 0 and served:
            gr = self._straggler.global_ranks
            exc = ResponseCacheJoinError(
                gr[joiner] if joiner < len(gr) else joiner, served)
            hvd_logging.error("%s", exc)
            _timeline.record_health_event("RC_JOIN_RACE")
            self._fail_all(str(exc), exc)
            self._shutdown.set()
            self._tick.set()

    # -- internals ---------------------------------------------------------

    def _failure_error(self) -> Exception:
        return (self._failure_exc if self._failure_exc is not None
                else HorovodCollectiveError(self._failure or "service failed"))

    def _fail_all(self, message: str, exc: Exception | None = None):
        with self._mu:
            # the failure and the pending snapshot commit together: a
            # submission either sees the failure or is failed here
            if exc is not None and self._failure_exc is None:
                self._failure_exc = exc
            self._failure = message
            pend = list(self._pending.values())
            self._pending.clear()
        if self._rcache is not None:
            self._rcache.invalidate(message)  # a next world proves anew
        for p in pend:
            p.event.set()

    def _on_peer_failure(self, dead_rank: int, reason: str) -> None:
        """A peer died (the watchdog's callback, or a round that timed
        out): every waiter fails with a :class:`PeerFailureError` naming
        it and the tensors still owed; new submissions raise it."""
        with self._mu:
            owed = sorted(self._pending)
        exc = _health.make_peer_failure_error(dead_rank, reason, owed)
        _timeline.record_health_event(f"PEER_DEAD.{dead_rank}")
        _conformance.record(
            "engine_service.py::DynamicService._on_peer_failure",
            "svc_abort", (self.pset_key, dead_rank))
        # a peer that announced its departure did not break the world: its
        # owed work fails all the same, but the confirmed entries shelve as
        # at a clean teardown (the successor's digest round proves them
        # again); without this one slow survivor's veto cold-starts the
        # whole next world. Before _fail_all, which invalidates the cache.
        if self._watchdog is not None and self._watchdog.peer_left(
                dead_rank):
            self._shelve_rcache()
        self._fail_all(str(exc), exc)
        # the fusion cycle's queued work cannot complete either: its
        # handles raise at synchronize()
        from .ops import fusion_cycle
        aborted = fusion_cycle.abort(str(exc))
        if aborted:
            hvd_logging.warning(
                "peer failure aborted %d queued async collectives", aborted)
        self._shutdown.set()
        self._tick.set()

    def _resolve_warm(self) -> None:
        """The one warm-digest round after a warm re-form: every member's
        digest equal and not empty means every member restored the same
        entries, and they are confirmed on every rank at this same point,
        so serving resumes after one real round a name instead of two.
        Any disagreement, or a gather that fails, drops them."""
        self._rc_warm_pending = False
        rc = self._rcache
        transport = self.transport
        if rc is None:
            return
        try:
            got = transport.kv.gather(f"{transport.prefix}/warm",
                                      transport.world_size,
                                      timeout=EXCHANGE_TIMEOUT_S)
            digests = set(got.values())
            mine = rc.warm_digest()
        except Exception as e:
            dropped = rc.drop_warm()
            if dropped:
                hvd_logging.warning(
                    "response cache: warm digest exchange failed (%s); "
                    "dropped %d warm entries (cold re-form)", e, dropped)
            return
        if len(digests) == 1 and mine in digests and mine != b"\x00" * 8:
            n = rc.confirm_warm()
            if n:
                _metrics.ELASTIC_WARM_REUSE.inc(
                    n, labels={"kind": "response"})
                hvd_logging.info(
                    "response cache: %d warm entries confirmed after one "
                    "digest round (shape %s)", n, self._rc_shape_key)
        else:
            dropped = rc.drop_warm()
            if dropped:
                hvd_logging.info(
                    "response cache: warm digests differ (a fresh member "
                    "or another shelf); dropped %d entries (cold "
                    "re-form)", dropped)

    def _awaiting(self) -> bool:
        """Whether a submitted request still waits for its plan."""
        with self._mu:
            return any(p.response is None for p in self._pending.values())

    def _loop(self):
        if self._device is not None and self._device.type == "cuda":
            # a joined rank's zero contributions run on this thread
            torch.cuda.set_device(self._device)
        while not self._shutdown.is_set():
            start = time.monotonic()
            # clear before the cycle: an enqueue racing the cycle sets it
            # again, and the next sleep is skipped, never lost
            self._tick.clear()
            try:
                self._run_cycle()
            except PeerFailureError as e:
                if not self._shutdown.is_set():
                    hvd_logging.error("%s", e)
                    self._on_peer_failure(e.rank, e.reason)
                return
            except HorovodCollectiveError as e:
                # an error every rank derives from the same agreed plan (a
                # joined rank refusing a broadcast or alltoall): each rank
                # fails from its own cycle, and no poison record races a
                # slower peer's cycle to fail it with another error
                self._fail_all(f"engine negotiation failed: {e}")
                return
            except Exception as e:
                hvd_logging.exception("engine cycle failed")
                if self._watchdog is not None:
                    # this process lives on and keeps beating: the poison
                    # record fails its peers within one tick
                    _timeline.record_health_event("POISON")
                    self._watchdog.poison(f"engine cycle failed: {e}")
                self._fail_all(f"engine negotiation failed: {e}")
                return
            cycle_s = envs.get_float(
                envs.CYCLE_TIME, self._idle_cycle_default_ms) / 1000.0
            adaptive = envs.get_bool(envs.ADAPTIVE_CYCLE, True)
            if adaptive:
                if self._awaiting():  # tick near the transport floor
                    cycle_s = min(cycle_s, envs.get_float(
                        envs.PENDING_CYCLE_TIME,
                        DEFAULT_PENDING_CYCLE_TIME_MS) / 1000.0)
            remaining = max(0.0, cycle_s - (time.monotonic() - start))
            if remaining <= 0:
                continue
            if adaptive:
                self._tick.wait(remaining)  # fresh enqueues end the sleep
            else:
                self._shutdown.wait(remaining)

    def _run_cycle(self):
        # the canonical cycle (dynamic.drive_cycle): bits against the
        # pre-ingest cache on every member, the AND-served set committed
        # first, then the ingest skips the served names
        if self._rc_warm_pending:
            self._resolve_warm()
        busy = self._awaiting()
        mine = self.engine.pop_requests()
        mybits = self.engine.cache_bits()
        cycle = self._cycle
        self._cycle += 1
        datas, bitvs = self.transport.exchange(cycle, mine, mybits,
                                               EXCHANGE_TIMEOUT_S)
        if busy:
            self._record_round_metrics()
        self._check_join_race(datas)
        self.engine.commit_cache_bits(and_bitvectors(bitvs))
        for rank, data in enumerate(datas):
            self.engine.ingest(rank, data)
        responses = self.engine.compute_responses()
        _timeline.mark_cycle()
        if responses:
            self._deliver(responses)
        now = time.monotonic()
        if now - self._last_stall_check > _STALL_CHECK_INTERVAL_S:
            self._last_stall_check = now
            self._check_stalls()

    def _record_round_metrics(self) -> None:
        """One busy round (work of this rank waited on it): its count and
        time, each member's submit lag, and the straggler tracker."""
        round_s = getattr(self.transport, "last_round_s", None)
        self.rounds += 1
        if round_s is None:  # an in-memory transport: no KV timing
            return
        self.round_seconds += round_s
        label = {"process_set": self.pset_key}
        _metrics.NEGOTIATION_ROUNDS.inc(labels=label)
        _metrics.NEGOTIATION_ROUND_SECONDS.observe(round_s, labels=label)
        lags = getattr(self.transport, "last_lags", None) or {}
        gr = self._straggler.global_ranks
        for r in sorted(lags):
            if 0 <= r < len(gr):
                _metrics.NEGOTIATION_SUBMIT_LAG.observe(
                    lags[r], labels={"rank": gr[r]})
        with self._mu:
            owed = sorted(self._pending)
        self._straggler.observe(lags, owed)

    def _deliver(self, responses: list[Response]):
        # While joined, the plans of tensors this rank never submitted run
        # with zero inputs (reference JoinOp) before any claimed plan is
        # delivered: the JOIN completes last in its cycle, so the user
        # thread cannot race the zero executions.
        exec_batch: list[Response] = []
        claimed: list[Response] = []
        with self._mu:
            joined = self._joined
            for resp in responses:
                if any(t in self._pending for t in resp.tensor_names):
                    claimed.append(resp)
                elif joined and not resp.is_error:
                    exec_batch.append(resp)
        # a peer is joined (this rank is not, or the plan is claimed):
        # what zeros cannot stand in for fails here, on every rank
        peer_joined = self.engine.join_pending()
        if exec_batch:
            from .ops import collectives
            collectives._execute_joined_zeros(exec_batch)  # raises if unsound
        with self._mu:
            for resp in claimed:
                if peer_joined and resp.type in _NOT_JOINABLE:
                    resp = Response(
                        type=RESP_ERROR, tensor_names=resp.tensor_names,
                        error_message=(
                            f"{resp.type_name} of {resp.tensor_names} while "
                            "another rank is joined: zero contribution is "
                            "defined for allreduce, allgather and barrier "
                            "only (docs/join.md)"))
                for tname in resp.tensor_names:
                    pend = self._pending.get(tname)
                    if pend is not None:
                        pend.response = resp
                        pend.order = self._delivered
                        self._delivered += 1
                        pend.event.set()
                        _timeline.record(tname, _timeline.NEGOTIATE,
                                         _timeline.PHASE_END)

    def _check_stalls(self):
        if envs.get_bool(envs.STALL_CHECK_DISABLE):
            return
        report, shutdown = self.engine.stall_report()
        for entry in report:
            hvd_logging.warning(
                "One or more tensors were submitted to be reduced/gathered "
                "but were not ready on all processes for %.0f seconds. This "
                "may indicate diverged control flow. Tensor: %s, ready "
                "ranks: %s, missing ranks: %s",
                entry.waiting_seconds, entry.tensor_name, entry.ready_ranks,
                entry.missing_ranks(self.engine.world_size))
        if shutdown:
            self._fail_all(
                "stalled tensors exceeded HVD_STALL_SHUTDOWN_TIME_SECONDS; "
                "shutting down negotiation (reference semantics, "
                "stall_inspector.h:71-86)")
            self._shutdown.set()


# --------------------------------------------------------------------------
# the process's services: one per process set over its member ranks (the
# reference's per-ProcessSet controller, process_set.h:26-84), made at the
# set's first negotiated collective
# --------------------------------------------------------------------------

_services: dict = {}  # set key -> DynamicService
_service_lock = threading.Lock()
# resets so far of each world (its MASTER_ADDR:MASTER_PORT), which keep a
# new world's keys apart from the last one's at the same address; an
# elastic round's fresh port starts its count at 0 on survivors and fresh
# workers alike
_generations: dict = {}


def _world_endpoint() -> str:
    return "{}:{}".format(os.environ.get("MASTER_ADDR", "local"),
                          os.environ.get("MASTER_PORT", "0"))


def _set_key(pset) -> str:
    """Stable cross-process key of a process set: its registered id, else
    a digest of its ranks."""
    if pset is None or pset.is_global:
        return "0"
    if pset.process_set_id is not None:
        return str(pset.process_set_id)
    import zlib
    return "u%x" % (zlib.crc32(repr(tuple(pset.ranks)).encode())
                    & 0xFFFFFFFF)


def enabled() -> bool:
    """Whether eager collectives negotiate: a launcher's KV store is set,
    ``HVD_DYNAMIC_ENGINE`` is not 0, and the world has several ranks."""
    return (envs.get_bool(envs.DYNAMIC_ENGINE, True)
            and bool(envs.get(envs.KV_ADDR))
            and runtime.is_initialized() and runtime.size() > 1)


def get_service(pset=None) -> DynamicService | None:
    """The negotiation service of ``pset`` (default: the global set), or
    None where eager collectives do not negotiate: see :func:`enabled`,
    and a set of one rank. Raises if the engine does not build."""
    if not enabled():
        return None
    members = (list(range(runtime.size())) if pset is None
               else pset.ranks)
    me = runtime.rank()
    if me not in members or len(members) <= 1:
        return None
    key = _set_key(pset)
    svc = _services.get(key)
    if svc is not None:
        return svc
    with _service_lock:
        svc = _services.get(key)
        if svc is None:
            from .runner.http_kv import KVClient
            engine = NativeEngine(world_size=len(members),
                                  rank=members.index(me))
            kv = KVClient(envs.get(envs.KV_ADDR),
                          envs.get_int(envs.KV_PORT, 0),
                          secret=envs.get(envs.SECRET_KEY))
            # keys scoped to this world instance and this set
            endpoint = _world_endpoint()
            prefix = "engine/{}/g{}/ps{}".format(
                endpoint, _generations.get(endpoint, 0), key)
            # past one leader group a round runs member -> leader ->
            # cross-leader -> fan-down (docs/negotiation.md); a smaller
            # world keeps the flat exchange byte for byte
            transport_cls = (HierarchicalTransport
                             if envs.hier_negotiation_enabled(len(members))
                             else KVTransport)
            svc = DynamicService(
                engine, transport_cls(kv, len(members), members.index(me),
                                      prefix=prefix),
                device=runtime.device(), global_ranks=members,
                pset_key="global" if key == "0" else key)
            _services[key] = svc
            hvd_logging.info(
                "negotiation service started for set %s: %d ranks over KV "
                "%s (%s)", key, len(members), envs.get(envs.KV_ADDR),
                transport_cls.__name__)
    return svc


def response_cache_stats() -> dict:
    """Each service's coordinator ResponseCache counters, by process set
    (``hvd.response_cache_stats()``); empty where the cache is off or no
    service runs."""
    with _service_lock:
        svcs = dict(_services)
    out = {}
    for key, svc in svcs.items():
        stats = svc.response_cache_stats()
        if stats is not None:
            out["global" if key == "0" else key] = stats
    return out


def mark_leaving() -> None:
    """Announce this rank's departure on purpose on every service's health
    channel (an elastic worker whose slot is gone): its peers then do not
    read its ceased beats as a death."""
    with _service_lock:
        svcs = list(_services.values())
    for svc in svcs:
        if svc._watchdog is not None:
            svc._watchdog.mark_leaving()


def reset_service() -> None:
    """Stop every service (at ``shutdown()``); auto-generated names start
    from zero again."""
    # queued work was negotiated against the services going away: it
    # fails (its handles raise), and the plans that pinned them drop
    from .ops import collectives, dispatch_cache, fusion_cycle
    aborted = fusion_cycle.abort("engine service reset")
    if aborted:
        hvd_logging.warning("engine service reset aborted %d queued "
                            "collective(s)", aborted)
    with _service_lock:
        for svc in _services.values():
            svc.stop()
        _services.clear()
        endpoint = _world_endpoint()
        _generations[endpoint] = _generations.get(endpoint, 0) + 1
    dispatch_cache.invalidate("engine service reset")
    collectives._auto_counters.clear()
