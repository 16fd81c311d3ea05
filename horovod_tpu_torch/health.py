"""Health watchdog: liveness beats, poison records and the coordinated
abort (port of ``horovod_tpu/health.py``).

The stall inspector only notices a missing peer once a collective waits on
it, and a dead rank left its peers blocked until the negotiation's 600 s
exchange deadline. The watchdog closes that gap with two signals over the
KV store the negotiation service already uses:

* **beats**: every rank PUTs a growing counter under ``<prefix>/beat/<rank>``
  each ``HVD_HEALTH_INTERVAL`` seconds (2). A peer is judged by when its
  counter last changed on *this* host's monotonic clock, so clock skew
  between hosts cannot fake a death; no change for ``HVD_HEALTH_TIMEOUT``
  seconds (30) declares it dead. A peer that never beat is not aged:
  services start at a rank's first negotiated collective, which may come
  minutes apart.
* **poison**: a rank whose negotiation loop failed PUTs
  ``<prefix>/poison/<rank>`` with the reason; its peers fail on their next
  tick, not after the beat timeout.

Either signal runs the owner's ``on_failure(rank, reason)`` exactly once;
the engine service uses it to fail every waiting collective with
:class:`~horovod_tpu_torch.exceptions.PeerFailureError`, naming the dead
rank and the tensors it owed. A rank that leaves on purpose
(``DynamicService.stop``) first publishes ``<prefix>/left/<rank>``, so its
ceased beats do not read as a death of the world.

With a :class:`~horovod_tpu_torch.negotiation.layout.GroupLayout` (the
hierarchical control plane), beats go under a scope a group and each
group's leader republishes its members' counters as one ``agg/<gid>`` blob
a tick: a monitor reads its own group's beats and the ``world / G``
aggregates instead of ``world`` keys. A dead leader freezes its whole
group from afar; the leader is its group's smallest rank, so it is the
first one named.

:class:`StragglerTracker` names the ranks that submit *late* (the slow end
of the spectrum), and :func:`health_stats` (``hvd.health_stats()``)
gathers the watchdogs, the retry counters and the fault rules.
"""

from __future__ import annotations

import json
import threading
import time

from . import metrics as _metrics
from . import timeline as _timeline
from .exceptions import PeerFailureError
from .utils import envs
from .utils import faults as _faults
from .utils import logging as hvd_logging
from .utils import retry as _retry


# Where an elastic worker's watchdog reports a peer's death on the
# launcher's KV store, as {"dead_rank": r, "reason": ..., "round": R}: the
# driver's PUT observer (elastic/bootstrap.py) hands it to
# ElasticDriver.record_peer_failure, which blacklists the dead rank's host
# and re-forms at once, without waiting for the dead process to be reaped.
PEER_FAILURE_KEY_PREFIX = "health/peerfail/"


def peer_failure_key(reporter_rank: int) -> str:
    return f"{PEER_FAILURE_KEY_PREFIX}{reporter_rank}"


def parse_peer_failure(key: str, payload: bytes):
    """``(dead_rank, reason, round_id)`` where ``key`` records a peer
    failure, else None (a malformed record is ignored: the process-exit
    path still sees the failure). ``round_id`` is the elastic round the
    reporter was in (-1 where unknown): ranks are numbered anew each
    round, so the driver resolves the rank against the reporter's round
    and a late report never blacklists an innocent successor."""
    if not key.startswith(PEER_FAILURE_KEY_PREFIX):
        return None
    try:
        body = json.loads(payload.decode())
        return (int(body["dead_rank"]), str(body.get("reason", "")),
                int(body.get("round", -1)))
    except (ValueError, KeyError, UnicodeDecodeError):
        return None


def enabled() -> bool:
    """The watchdog runs while beats are on (``HVD_HEALTH_INTERVAL`` > 0;
    0 turns it off)."""
    return envs.health_interval_s() > 0.0


def watchdog_budget_s() -> float:
    """The longest a peer's death can go undeclared: one beat interval of
    publish skew plus the no-beat timeout. Waits that promise to fail
    over within the watchdog's budget size their deadlines from it."""
    return envs.health_interval_s() + envs.health_timeout_s()


class HealthWatchdog:
    """One rank's view of its peers' liveness over a shared KV store
    (``put``, ``get``, ``keys`` and, optionally, ``gather``). One daemon
    thread both beats and watches, at the same cadence, so this rank's
    beats are never starved by its own monitor."""

    def __init__(self, kv, world_size: int, rank: int, prefix: str,
                 on_failure, interval_s: float | None = None,
                 timeout_s: float | None = None, global_ranks=None,
                 layout=None):
        self.kv = kv
        self.world_size = world_size
        self.rank = rank
        self.prefix = prefix.rstrip("/")
        self.on_failure = on_failure
        self.layout = layout
        self._gid = layout.group_of(rank) if layout is not None else 0
        self._leads = layout.is_leader(rank) if layout is not None else False
        self.interval_s = (interval_s if interval_s is not None
                           else envs.health_interval_s())
        self.timeout_s = (timeout_s if timeout_s is not None
                          else envs.health_timeout_s())
        # beat keys use the service's member indices; what goes out (the
        # callback, messages) names global ranks
        self.global_ranks = (list(global_ranks) if global_ranks is not None
                             else list(range(world_size)))
        self._beat = 0
        self._beats_sent = 0
        self._beat_errors = 0
        # member -> (last counter, monotonic time it last changed); None
        # until its first beat
        self._seen: dict[int, tuple[int | None, float | None]] = {}
        self._left: set[int] = set()  # members that left on purpose
        self._failed: tuple[int, str] | None = None
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        with self._mu:
            for r in range(self.world_size):
                if r != self.rank:
                    self._seen[r] = (None, None)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"hvd-health-{self.rank}")
        self._thread.start()
        _register(self)

    def stop(self, join: bool = True) -> None:
        """Stop beating and watching."""
        self._stop.set()
        t = self._thread
        if join and t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._thread = None
        _unregister(self)

    # -- protocol ----------------------------------------------------------

    def _beat_key(self, rank: int) -> str:
        if self.layout is not None:
            return f"{self.prefix}/b{self.layout.group_of(rank)}/{rank}"
        return f"{self.prefix}/beat/{rank}"

    def poison(self, reason: str) -> None:
        """Publish a poison record for this rank (it failed in a way its
        peers cannot see): they fail on their next tick."""
        try:
            self.kv.put(f"{self.prefix}/poison/{self.rank}", reason.encode())
        except Exception as e:  # best effort: the beat timeout still holds
            hvd_logging.warning("health: poison publish failed: %s", e)

    def mark_leaving(self) -> None:
        """Announce a departure on purpose: this rank's beats are about to
        cease, and its peers should not read the silence as a death of the
        world."""
        try:
            self.kv.put(f"{self.prefix}/left/{self.rank}", b"1")
        except Exception as e:  # best effort, as poison
            hvd_logging.warning("health: leave marker publish failed: %s",
                                e)

    def report_peer_failure(self, dead_rank: int, reason: str) -> None:
        """Record a death on the launcher's KV store, where an elastic
        driver reads it (nothing outside an elastic worker)."""
        if not envs.get_bool(envs.ELASTIC):
            return
        try:
            self.kv.put(peer_failure_key(self.rank), json.dumps(
                {"dead_rank": dead_rank, "reason": reason,
                 "round": envs.get_int(envs.ELASTIC_ROUND, -1)}).encode())
        except Exception as e:
            hvd_logging.warning("health: peer-failure publish failed: %s",
                                e)

    def peer_left(self, global_rank: int) -> bool:
        """Whether ``global_rank`` announced a departure on purpose before
        this watchdog's failure decision: its owed work fails all the
        same, but the world is not broken, and warm state may shelve."""
        with self._mu:
            left = set(self._left)
        return any(self.global_ranks[m] == global_rank
                   for m in left if m < len(self.global_ranks))

    def _marked(self, what: str) -> dict[int, str]:
        """``{member: key}`` of the ``<prefix>/<what>/<member>`` markers;
        ``{}`` when the store cannot be read this tick."""
        try:
            names = self.kv.keys(f"{self.prefix}/{what}")
        except Exception:  # a KV flap: this tick reads nothing
            return {}
        marker = f"{self.prefix}/{what}/"
        out = {}
        for key in names:
            try:
                out[int(key[len(marker):])] = key
            except ValueError:
                continue
        return out

    # -- monitor loop ------------------------------------------------------

    def _loop(self) -> None:
        decided = False
        while not self._stop.is_set():
            self._publish_beat()
            if not decided:
                dead = self._check_peers()
                if dead is not None:
                    self._decide(*dead)
                    # one decision in a watchdog's life, but beats go on
                    # until stop(): a rank that fell silent on deciding
                    # would look dead to the peers still watching
                    decided = True
            self._stop.wait(self.interval_s)

    def _decide(self, member: int, reason: str) -> None:
        rank = self.global_ranks[member]
        with self._mu:
            if self._failed is not None:
                return
            self._failed = (rank, reason)
        _metrics.HEALTH_PEER_FAILURES.inc(labels={"rank": rank})
        hvd_logging.error("health watchdog: peer rank %d failed: %s", rank,
                          reason)
        if member not in self._left:
            # a rank that left on purpose is no failure for the driver to
            # blacklist
            self.report_peer_failure(rank, reason)
        try:
            self.on_failure(rank, reason)
        except Exception:
            hvd_logging.exception("health on_failure callback failed")

    def _publish_beat(self) -> None:
        self._beat += 1
        try:
            # one retry ladder a beat: a KV flap must not look like our
            # death to the peers
            _retry.call(lambda: self.kv.put(self._beat_key(self.rank),
                                            str(self._beat).encode()),
                        what="health.beat")
            self._beats_sent += 1
            _metrics.HEALTH_BEATS.inc()
        except Exception as e:
            self._beat_errors += 1
            _metrics.HEALTH_BEAT_ERRORS.inc()
            hvd_logging.warning("health: beat publish failed: %s", e)

    def _scope_counters(self, scope: str,
                        wait_s: float) -> dict[int, int] | None:
        """``{member: counter}`` of the beat keys under ``scope``, by one
        server-side gather where the store has one (our own key satisfies
        a count of 1, so it returns at once); ``{}`` before any key
        exists, None when the store cannot be read (never age peers on our
        own error)."""
        gather = getattr(self.kv, "gather", None)
        try:
            if gather is not None:
                got = gather(scope, 1, timeout=wait_s)
            else:
                got = {}
                for r in list(self._seen) + [self.rank]:
                    key = self._beat_key(r)
                    if key.startswith(scope + "/"):
                        raw = self.kv.get(key)
                        if raw is not None:
                            got[key] = raw
        except TimeoutError:
            return {}
        except Exception:
            return None
        out: dict[int, int] = {}
        for key, raw in got.items():
            try:
                out[int(key.rsplit("/", 1)[1])] = int(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue
        return out

    def _fetch_beats(self) -> dict[int, int] | None:
        if self.layout is None:
            return self._scope_counters(f"{self.prefix}/beat",
                                        max(self.interval_s, 0.2))
        # a short wait: a blocking read here would stretch the tick past
        # interval_s and delay our own next beat
        mine = self._scope_counters(f"{self.prefix}/b{self._gid}", 0.05)
        if mine is None:
            return None
        if self._leads:  # the group's aggregate advances while we live
            try:
                self.kv.put(f"{self.prefix}/agg/{self._gid}", json.dumps(
                    {str(r): c for r, c in sorted(mine.items())}).encode())
            except Exception as e:  # best effort: the next tick retries
                hvd_logging.warning(
                    "health: beat aggregate publish failed: %s", e)
        out = dict(mine)
        gather = getattr(self.kv, "gather", None)
        try:
            if gather is not None:
                aggs = gather(f"{self.prefix}/agg", 1, timeout=0.05)
            else:
                aggs = {}
                for g in range(self.layout.n_groups):
                    raw = self.kv.get(f"{self.prefix}/agg/{g}")
                    if raw is not None:
                        aggs[f"{self.prefix}/agg/{g}"] = raw
        except TimeoutError:
            aggs = {}  # no leader has aggregated yet
        except Exception:
            return None
        for key, blob in aggs.items():
            try:
                gid = int(key.rsplit("/", 1)[1])
                counters = json.loads(blob.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            if gid == self._gid:
                continue  # our own group's raw beats are fresher
            for r, c in counters.items():
                try:
                    out.setdefault(int(r), int(c))
                except (TypeError, ValueError):
                    continue
        return out

    def _check_poison(self):
        for r, key in sorted(self._marked("poison").items()):
            if r == self.rank or r not in self._seen:
                continue
            try:
                reason = (self.kv.get(key) or b"").decode(errors="replace")
            except Exception:
                reason = "(reason unavailable)"
            return r, f"poison record: {reason}"
        return None

    def _check_peers(self):
        """``(member, reason)`` of the first dead peer, else None."""
        now = time.monotonic()
        self._left.update(self._marked("left"))
        dead = self._check_poison()
        if dead is not None:
            return dead
        beats = self._fetch_beats()
        if beats is None:
            return None
        for r in sorted(self._seen):
            value = beats.get(r)
            with self._mu:
                last_value, changed_at = self._seen[r]
                if value is not None and value != last_value:
                    self._seen[r] = (value, now)
                    continue
                if changed_at is None:
                    continue  # never beaten yet
                silent_s = now - changed_at
            if silent_s > self.timeout_s:
                if r in self._left:
                    # not a death, but its owed work cannot complete
                    return r, (f"left the world (graceful departure; "
                               f"beats ceased {silent_s:.1f}s ago) — "
                               "its pending work cannot complete")
                return r, (f"no liveness beat for {silent_s:.1f}s "
                           f"(HVD_HEALTH_TIMEOUT={self.timeout_s:g}s)")
        return None

    # -- introspection -----------------------------------------------------

    def last_seen(self) -> dict[int, float | None]:
        """Seconds since each peer's counter last moved, by global rank;
        None for a peer not yet seen beating."""
        now = time.monotonic()
        with self._mu:
            return {self.global_ranks[r]:
                    (None if changed_at is None else now - changed_at)
                    for r, (_v, changed_at) in sorted(self._seen.items())}

    def describe_peers(self) -> str:
        """The peers' liveness in words, for error messages."""
        seen = self.last_seen()
        if not seen:
            return "no peers tracked"
        return ", ".join(
            (f"rank {r}: beat {s:.1f}s ago" if s is not None
             else f"rank {r}: no beat observed yet")
            for r, s in seen.items())

    def stats(self) -> dict:
        with self._mu:
            failed = self._failed
        return {
            "rank": self.global_ranks[self.rank],
            "world_size": self.world_size,
            "member_ranks": list(self.global_ranks),
            "interval_s": self.interval_s,
            "timeout_s": self.timeout_s,
            "beats_sent": self._beats_sent,
            "beat_errors": self._beat_errors,
            "peers_last_seen_s": self.last_seen(),
            "failed_peer": (None if failed is None
                            else {"rank": failed[0], "reason": failed[1]}),
        }


def make_peer_failure_error(dead_rank: int, reason: str,
                            owed_tensors=()) -> PeerFailureError:
    """The error every waiter of a coordinated abort raises."""
    return PeerFailureError(dead_rank, reason, owed_tensors)


class StragglerTracker:
    """A round's straggler, from the submit lags the transport measured on
    the KV server's clock. A busy round whose last submitter lags past
    ``HVD_STRAGGLER_THRESHOLD`` seconds (1) counts in
    ``hvd_straggler_rounds_total{rank=<global rank>}`` and drops a
    ``STRAGGLER.<rank>`` instant; ``sustain_rounds`` rounds in a row that
    blame one rank log a warning naming it (at most one a
    ``warn_interval_s``). ``observe`` runs on the cycle thread."""

    def __init__(self, my_rank: int, global_ranks, *,
                 threshold_s: float | None = None,
                 sustain_rounds: int = 3,
                 warn_interval_s: float = 30.0):
        self.rank = my_rank
        self.global_ranks = list(global_ranks)
        self.threshold_s = (threshold_s if threshold_s is not None
                            else envs.straggler_threshold_s())
        self.sustain_rounds = max(int(sustain_rounds), 1)
        self.warn_interval_s = warn_interval_s
        self._mu = threading.Lock()
        self._streak_rank: int | None = None  # a member index
        self._streak = 0
        self._last_warn_at: dict[int, float] = {}
        self._rounds: dict[int, int] = {}  # global rank -> rounds blamed
        self._warnings = 0
        self._last_warning: str | None = None

    def observe(self, lags: dict, owed_tensors=()) -> None:
        """One busy round's lags: member -> seconds behind the first
        submitter."""
        if not lags:
            return
        worst = max(sorted(lags), key=lambda r: lags[r])
        lag = lags[worst]
        if worst == self.rank or lag < self.threshold_s:
            # our own lag cannot be seen honestly (our put gates our
            # gather), and a round under the threshold ends a streak
            with self._mu:
                self._streak_rank = None
                self._streak = 0
            return
        gr = self.global_ranks[worst]
        _metrics.STRAGGLER_ROUNDS.inc(labels={"rank": gr})
        _timeline.record_health_event(f"STRAGGLER.{gr}")
        now = time.monotonic()
        warn = None
        with self._mu:
            self._rounds[gr] = self._rounds.get(gr, 0) + 1
            if self._streak_rank == worst:
                self._streak += 1
            else:
                self._streak_rank = worst
                self._streak = 1
            if (self._streak >= self.sustain_rounds
                    and now - self._last_warn_at.get(gr, float("-inf"))
                    >= self.warn_interval_s):
                self._last_warn_at[gr] = now
                warn = (
                    f"negotiation straggler: global rank {gr} was last "
                    f"to submit for {self._streak} consecutive rounds, "
                    f"{lag:.3f}s behind the first submitter "
                    f"(HVD_STRAGGLER_THRESHOLD={self.threshold_s:g}s); "
                    f"tensors owed to this rank: "
                    f"{sorted(owed_tensors)}")
                self._warnings += 1
                self._last_warning = warn
        if warn is not None:
            hvd_logging.warning("%s", warn)

    def stats(self) -> dict:
        with self._mu:
            return {
                "threshold_s": self.threshold_s,
                "straggler_rounds": dict(sorted(self._rounds.items())),
                "current_streak": (
                    None if self._streak_rank is None
                    else {"rank": self.global_ranks[self._streak_rank],
                          "rounds": self._streak}),
                "warnings": self._warnings,
                "last_warning": self._last_warning,
            }


def straggler_blames() -> dict[int, int]:
    """The straggler rounds this process's trackers have charged to each
    global rank, from ``hvd_straggler_rounds_total``: the eviction sensor
    of the autoscale policy. Each worker's observer publishes deltas of it
    and the driver's policy adds the blames up across reporters."""
    out: dict[int, int] = {}
    for labelitems, v in _metrics.STRAGGLER_ROUNDS.series().items():
        try:
            out[int(dict(labelitems).get("rank"))] = int(v)
        except (TypeError, ValueError):
            continue
    return out


_registry_mu = threading.Lock()
_watchdogs: list[HealthWatchdog] = []


def _register(w: HealthWatchdog) -> None:
    with _registry_mu:
        if w not in _watchdogs:
            _watchdogs.append(w)


def _unregister(w: HealthWatchdog) -> None:
    with _registry_mu:
        if w in _watchdogs:
            _watchdogs.remove(w)


def health_stats() -> dict:
    """``hvd.health_stats()``: retries and give-ups by site, the fault
    rules' counters and every running watchdog's view."""
    with _registry_mu:
        dogs = list(_watchdogs)
    return {"retries": _retry.stats(), "faults": _faults.stats(),
            "watchdogs": [w.stats() for w in dogs]}
