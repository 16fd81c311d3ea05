"""Coordinator ResponseCache: steady-state negotiation answered locally
(port of ``horovod_tpu/negotiation/response_cache.py``).

Once a tensor's negotiated response is held by every rank's native cache,
a fact the protocol itself proves, a later submission of the identical
request is answered from this cache with no KV round, so a steady state
costs no round whatever the world's size.

**Coherence.** An entry becomes *confirmed* (servable) only when a real
round returns its response with ``from_cache=True``. The native engines
set that flag from the AND of every rank's cache bit vector: it holds iff
every rank's native cache held the entry in that cycle, and the symmetric
protocol delivers it at the same negotiation index on every rank. So every
rank flips from "negotiate" to "serve" at the same occurrence of the name.
A rank whose bit differs (an eviction at a smaller capacity, changed
metadata) breaks the AND, the response comes back ``from_cache=False``,
and the entry stays unconfirmed: divergence forces a real round.

**Invalidation.** Serving also needs the native cache to still hold the
name (``NativeEngine.cache_has``), which the ingested request stream
updates on every rank. The whole cache drops at a knob-override epoch
move, at service stop and at a coordinated abort. While a JOIN is in
flight the service bypasses the cache: a joined rank learns of the
collectives it owes zeros to from real rounds only.

The shelf and the warm methods keep confirmed entries across a re-form of
a world of the same shape (restored *warm*, servable after one digest
round proves every member restored the same entries): the service
shelves at a stop on purpose (``engine_service.DynamicService.stop``) and
restores at its start in a re-formed world (``HVD_ELASTIC_WARM``).
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict

from .. import conformance as _conformance
from .. import metrics as _metrics
from ..dynamic import REQ_ALLGATHER, REQ_BARRIER, REQ_JOIN, Response


def cacheable(req: dict) -> bool:
    """Whether a request may be answered from the cache, by the native
    cache's own rules: an allgather's first dims, an uneven alltoall's
    splits, a barrier and a join are never cached."""
    if req.get("request_type") in (REQ_ALLGATHER, REQ_BARRIER, REQ_JOIN):
        return False
    return not tuple(req.get("splits") or ())


def signature(req: dict) -> tuple:
    """A request's full identity: a cached response answers only a request
    equal in every negotiated field."""
    return (
        req["name"],
        req.get("request_type"),
        req.get("dtype", 0),
        req.get("element_size", 4),
        tuple(req.get("shape", ())),
        req.get("root_rank", -1),
        req.get("group_id", -1),
        req.get("reduce_op", -1),
        float(req.get("prescale", 1.0)),
        float(req.get("postscale", 1.0)),
        req.get("splits_crc", 0),
    )


class _Entry:
    __slots__ = ("response", "confirmed", "warm")

    def __init__(self, response: Response, confirmed: bool,
                 warm: bool = False):
        self.response = response
        self.confirmed = confirmed
        self.warm = warm  # restored, not yet proven across the world


# The shelf: a stopping service's entries by its shape key (scope, process
# set, world size, rank); its cap grows with the largest world on it, so
# one world's re-form does not evict its own shapes.
_SHELF_SHAPES = 16
_shelf_mu = threading.Lock()
_shelf: "OrderedDict[tuple, list]" = OrderedDict()


def _shelf_cap() -> int:
    """Caller holds ``_shelf_mu``; index 2 of a key is the world size."""
    worlds = [k[2] for k in _shelf if len(k) > 2 and isinstance(k[2], int)]
    return max(_SHELF_SHAPES, 4 * max(worlds, default=0))


def shelve(shape: tuple, items: list) -> None:
    """Park a stopping service's entries under its shape key."""
    if not items:
        return
    with _shelf_mu:
        _shelf[shape] = items
        _shelf.move_to_end(shape)
        cap = _shelf_cap()
        while len(_shelf) > cap:
            _shelf.popitem(last=False)


def take_shelved(shape: tuple) -> list | None:
    with _shelf_mu:
        return _shelf.pop(shape, None)


def clear_shelf() -> None:
    with _shelf_mu:
        _shelf.clear()


class ResponseCache:
    """One negotiation service's cache: LRU over ``capacity`` names (the
    ``HVD_RESPONSE_CACHE`` knob). Submitting threads look up while the
    issuing thread inserts, under one lock."""

    def __init__(self, capacity: int, pset_key: str = "global"):
        self.capacity = int(capacity)
        self._pset = pset_key
        self._mu = threading.Lock()
        # name -> (signature, entry)
        self._entries: "OrderedDict[str, tuple[tuple, _Entry]]" = \
            OrderedDict()
        self._hits = 0
        self._misses = 0
        self._served_batches = 0
        self._invalidations = 0
        label = {"process_set": pset_key}
        self._m_hits = _metrics.RESPONSE_CACHE_HITS.bind(label)
        self._m_misses = _metrics.RESPONSE_CACHE_MISSES.bind(label)

    # -- lookup ------------------------------------------------------------

    def lookup_confirmed(self, req: dict) -> Response | None:
        """The cached response of ``req`` where its entry is confirmed and
        its signature equal, else None. Counts nothing: the service counts
        a batch's decision, all or nothing."""
        if self.capacity <= 0 or not cacheable(req):
            return None
        sig = signature(req)
        with self._mu:
            held = self._entries.get(req["name"])
            if held is None:
                return None
            held_sig, entry = held
            if held_sig != sig or not entry.confirmed:
                return None
            self._entries.move_to_end(req["name"])
            return entry.response

    # -- population --------------------------------------------------------

    def note_response(self, req: dict, resp: Response) -> None:
        """Record a delivered response of a real round: ``from_cache``
        confirms the entry, a fresh response inserts or updates it
        unconfirmed."""
        if self.capacity <= 0 or not cacheable(req) or resp.is_error:
            return
        if len(resp.tensor_names) != 1:
            return  # a fused response answers no single name
        sig = signature(req)
        with self._mu:
            held = self._entries.get(req["name"])
            if held is not None and held[0] == sig:
                flipped = resp.from_cache and not held[1].confirmed
                held[1].confirmed = held[1].confirmed or resp.from_cache
                held[1].response = resp
                self._entries.move_to_end(req["name"])
            else:
                flipped = resp.from_cache
                self._entries[req["name"]] = (
                    sig, _Entry(resp, resp.from_cache))
                self._entries.move_to_end(req["name"])
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
            if flipped:
                # lockstep: every rank confirms this name at this point
                # of its stream
                _conformance.record(
                    "negotiation/response_cache.py::"
                    "ResponseCache.note_response",
                    "confirm", (self._pset, req["name"]))

    # -- the service's decisions -------------------------------------------

    def count_served(self, n: int) -> None:
        with self._mu:
            self._hits += n
            self._served_batches += 1
            # lockstep: a batch is served all or nothing, at the same
            # serve index on every rank
            _conformance.record(
                "negotiation/response_cache.py::ResponseCache.count_served",
                "served", (self._pset, n, self._served_batches))
        self._m_hits.inc(n)

    def count_missed(self, n: int) -> None:
        if n <= 0:
            return
        with self._mu:
            self._misses += n
        self._m_misses.inc(n)

    # -- warm entries (a re-form to the same shape) ------------------------

    def export_entries(self) -> list:
        """``(name, signature, response)`` of every confirmed or warm
        entry, for the shelf."""
        with self._mu:
            return [(name, held[0], held[1].response)
                    for name, held in self._entries.items()
                    if held[1].confirmed or held[1].warm]

    def restore_warm(self, items: list) -> int:
        """Adopt a shelved snapshot as warm entries: held but not servable
        until :meth:`confirm_warm`."""
        n = 0
        with self._mu:
            for name, sig, resp in items:
                if len(self._entries) >= self.capacity:
                    break
                self._entries[name] = (sig, _Entry(resp, False, warm=True))
                n += 1
        # local: a fresh member restores nothing
        _conformance.record(
            "negotiation/response_cache.py::ResponseCache.restore_warm",
            "warm_restore", (self._pset, n))
        return n

    def warm_count(self) -> int:
        with self._mu:
            return sum(1 for _, e in self._entries.values() if e.warm)

    def warm_digest(self) -> bytes:
        """Eight bytes over the warm set's content: equal on every member
        iff every member restored the same entries; an empty set digests
        to zeros, which vetoes the warm path everywhere."""
        with self._mu:
            items = sorted(
                (name, held[0], repr(held[1].response))
                for name, held in self._entries.items() if held[1].warm)
        if not items:
            return b"\x00" * 8
        crc = 0
        for name, sig, resp_repr in items:
            crc = zlib.crc32(repr((name, sig, resp_repr)).encode(), crc)
        return len(items).to_bytes(4, "little") + crc.to_bytes(4, "little")

    def confirm_warm(self) -> int:
        """Every member restored the same warm set: confirm it (serving
        still waits for the native cache, one real round a name)."""
        n = 0
        with self._mu:
            for _, e in self._entries.values():
                if e.warm:
                    e.warm, e.confirmed = False, True
                    n += 1
        _conformance.record(
            "negotiation/response_cache.py::ResponseCache.confirm_warm",
            "warm_confirm", (self._pset, n))
        return n

    def drop_warm(self) -> int:
        """The members' warm sets differ, or their digests could not be
        exchanged: drop them (the cold path)."""
        with self._mu:
            stale = [name for name, held in self._entries.items()
                     if held[1].warm]
            for name in stale:
                del self._entries[name]
        _conformance.record(
            "negotiation/response_cache.py::ResponseCache.drop_warm",
            "warm_drop", (self._pset, len(stale)))
        return len(stale)

    # -- invalidation ------------------------------------------------------

    def invalidate(self, reason: str = "") -> int:
        """Drop every entry; returns how many there were."""
        with self._mu:
            n = len(self._entries)
            self._entries.clear()
            if n:
                self._invalidations += 1
        return n

    def drop_name(self, name: str) -> None:
        with self._mu:
            self._entries.pop(name, None)

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def confirmed_count(self) -> int:
        with self._mu:
            return sum(1 for _, e in self._entries.values() if e.confirmed)

    def stats(self) -> dict:
        with self._mu:
            total = self._hits + self._misses
            return {
                "capacity": self.capacity,
                "entries": len(self._entries),
                "confirmed": sum(1 for _, e in self._entries.values()
                                 if e.confirmed),
                "warm": sum(1 for _, e in self._entries.values() if e.warm),
                "hits": self._hits,
                "misses": self._misses,
                "served_batches": self._served_batches,
                "invalidations": self._invalidations,
                "hit_rate": (self._hits / total) if total else 0.0,
            }
