"""Closed-loop elastic autoscaling, ``HVD_AUTOSCALE`` (port of
``horovod_tpu/elastic/policy.py``).

The membership actions of scripted churn (``worker:add/remove/preempt``),
chosen instead by a controller on the driver's side that reads the
workers' metrics. Two halves:

* **Observer** (every worker, :class:`CommitObserver`), hooked into
  ``State.commit()``: it measures commit-to-commit step time, records it
  in the registry (``hvd_elastic_step_seconds``,
  ``hvd_elastic_slo_violations_total``) and, about twice a policy window,
  publishes a sensor blob to the launcher's KV store under
  ``autoscale/sensor/<rank>``: the SLO violations, the fusion cycle's
  pending bytes, the QoS admission wait, the recovery times and this
  rank's :func:`~horovod_tpu_torch.health.straggler_blames`, each a
  windowed delta of the registry. A blob names its round: ranks renumber
  at a re-form. A process is a rank here, so there is one observer a
  process (the JAX package keeps one a loopback rank thread).

* **Policy** (the driver, :class:`AutoscalePolicy`): a thread evaluating
  every ``HVD_AUTOSCALE_INTERVAL`` seconds.

  - **scale-up** when the mean SLO-violation share of the reporting ranks
    reaches half for ``HVD_AUTOSCALE_BREACH_WINDOWS`` windows in a row
    and the world is under its ceiling;
  - **scale-down** when every rank reports an idle window (mean step time
    under ``HVD_AUTOSCALE_IDLE_FACTOR`` x SLO, no violation, nothing
    queued) for ``HVD_AUTOSCALE_IDLE_WINDOWS`` windows in a row and the
    world is above its floor: the newest (highest-rank) host leaves with
    a grace window through the slot-lost path, losing no step;
  - **evict-and-replace** when the straggler blames name one global rank
    for ``HVD_AUTOSCALE_EVICT_WINDOWS`` windows in a row: the blamed
    rank's host leaves gracefully and a replacement with as many slots
    joins in the same discovery tick, so the world re-forms once at the
    same size.

  Evict comes before add, add before remove. A decision is tagged with
  the round it was evaluated in and re-checks that round under the
  driver's round lock when it acts, so a decision racing a re-form, or
  blaming a rank that already left, becomes a counted ``hold``. Streaks,
  a cooldown after every action and the world's bounds keep a flapping
  load from moving the world. A remove is held while the measured cost of
  a re-form exceeds the idle time it would reclaim. Any evaluation error
  is a ``hold`` with a :class:`PolicyEvalError` warning, never a failed
  job; every decision counts in
  ``hvd_elastic_policy_decisions_total{action,reason,rank}`` and drops an
  ``AUTOSCALE.<action>.<reason>`` instant on the timeline.

**Where a new host comes from.** A worker is a process that the launcher
starts on a named machine, so a made-up name cannot run one. A scale-up
and a replacement first bring back hosts that the policy or scripted
churn took out (:meth:`FixedHosts.readmit
<horovod_tpu_torch.elastic.discovery.FixedHosts.readmit>`, oldest
first; a replacement only a host whose own slots cover its victim's),
and only then mint ``auto<N>`` as the JAX package does. A host comes back
with no more slots than it had: its ``-H`` count is its cards.
"""

from __future__ import annotations

import contextlib
import json

from .. import health as _health
from .. import metrics as _metrics
from .. import timeline as _timeline
from ..utils import envs
from ..utils import faults as _faults
from ..utils import invariants as _inv
from ..utils import logging as hvd_logging

SENSOR_KEY_PREFIX = "autoscale/sensor/"


class PolicyEvalError(RuntimeError):
    """A policy evaluation window failed (a sensor read, the aggregation
    or an action). Never raised into the job: the window records a
    ``hold``/``error`` decision and the next one starts clean."""


def sensor_key(rank: int) -> str:
    return f"{SENSOR_KEY_PREFIX}{rank}"


# ---------------------------------------------------------------------------
# the worker's observer (the State.commit hook)
# ---------------------------------------------------------------------------

class CommitObserver:
    """One rank's sensors: step timing at every commit, and a sensor blob
    about twice a policy window. Every value is a windowed delta of this
    process's registry."""

    def __init__(self):
        self.rank = envs.get_int(envs.RANK, -1)
        self.slo_s = envs.autoscale_slo_s()
        self.interval_s = envs.autoscale_interval_s()
        self._last_commit_t: float | None = None
        self._last_publish_t = 0.0
        self._seq = 0
        self._steps = 0
        self._violations = 0
        self._step_s_sum = 0.0
        self._prev_blames: dict[int, int] = {}
        self._prev_qos: tuple[float, int] = (0.0, 0)
        self._prev_recovery: tuple[float, int] = (0.0, 0)
        self._client = None
        self._client_failed = False

    def _kv(self):
        if self._client is None and not self._client_failed:
            addr = envs.get(envs.KV_ADDR)
            if not addr:
                self._client_failed = True
                return None
            try:
                from ..runner.http_kv import KVClient
                self._client = KVClient(addr,
                                        envs.get_int(envs.KV_PORT, 0),
                                        secret=envs.get(envs.SECRET_KEY))
            except Exception as e:
                self._client_failed = True
                hvd_logging.warning(
                    "autoscale observer: KV client unavailable (%s); "
                    "sensors off for this worker", e)
        return self._client

    def note(self) -> None:
        """One ``State.commit()``."""
        now = _inv.monotonic()
        prev = self._last_commit_t
        self._last_commit_t = now
        if prev is None:
            self._last_publish_t = now  # the window opens at the 1st commit
            return
        dt = now - prev
        _metrics.ELASTIC_STEP_SECONDS.observe(dt)
        self._steps += 1
        self._step_s_sum += dt
        if self.slo_s > 0 and dt > self.slo_s:
            self._violations += 1
            _metrics.ELASTIC_SLO_VIOLATIONS.inc()
        if now - self._last_publish_t >= self.interval_s / 2.0:
            self._publish(now)

    def _publish(self, now: float) -> None:
        kv = self._kv()
        if kv is None:
            return
        blames = _health.straggler_blames()
        blame_delta = {r: c - self._prev_blames.get(r, 0)
                       for r, c in blames.items()
                       if c - self._prev_blames.get(r, 0) > 0}
        qos_sum, qos_count = _qos_wait_totals()
        d_sum = qos_sum - self._prev_qos[0]
        d_count = qos_count - self._prev_qos[1]
        rec_sum, rec_count = _recovery_totals()
        dr_sum = rec_sum - self._prev_recovery[0]
        dr_count = rec_count - self._prev_recovery[1]
        self._seq += 1
        blob = {
            "rank": envs.get_int(envs.RANK, self.rank),
            "round": envs.get_int(envs.ELASTIC_ROUND, -1),
            "seq": self._seq,
            "steps": self._steps,
            "violations": self._violations,
            "step_s_mean": (self._step_s_sum / self._steps
                            if self._steps else 0.0),
            "pending_bytes": float(_metrics.FUSION_PENDING_BYTES.value()),
            "qos_wait_s_mean": (d_sum / d_count if d_count else 0.0),
            # the measured recovery cost (re-form and state restore): the
            # scale-down brake's sensor
            "restore_s_sum": dr_sum,
            "restore_count": dr_count,
            "straggler": {str(r): c for r, c in
                          sorted(blame_delta.items())},
        }
        self._prev_blames = blames
        self._prev_qos = (qos_sum, qos_count)
        self._prev_recovery = (rec_sum, rec_count)
        self._steps = 0
        self._violations = 0
        self._step_s_sum = 0.0
        self._last_publish_t = now
        try:
            kv.put(sensor_key(blob["rank"]), json.dumps(blob).encode())
        except Exception as e:
            # a lost sensor makes the policy hold; the job goes on
            hvd_logging.debug("autoscale sensor publish failed: %s", e)


def _histogram_totals(*hists) -> tuple[float, int]:
    total_s, total_n = 0.0, 0
    for hist in hists:
        for _labels, h in hist.series().items():
            total_s += getattr(h, "sum", 0.0)
            total_n += getattr(h, "count", 0)
    return total_s, total_n


def _qos_wait_totals() -> tuple[float, int]:
    """(sum_s, count) over this rank's QoS admission-wait series."""
    return _histogram_totals(_metrics.QOS_ADMISSION_WAIT)


def _recovery_totals() -> tuple[float, int]:
    """(sum_s, count) over this rank's re-forms (interrupt to training
    again) and state restores."""
    return _histogram_totals(_metrics.ELASTIC_REFORM_SECONDS,
                             _metrics.CKPT_RESTORE_SECONDS)


# The process's observer; False caches "autoscale off", so that a commit
# with the policy off costs one global read.
_process_observer: "CommitObserver | bool | None" = None


def note_commit() -> None:
    """The ``State.commit()`` seam."""
    global _process_observer
    obs = _process_observer
    if obs is None:
        obs = _process_observer = (
            CommitObserver() if envs.autoscale_enabled() else False)
    if obs is not False:
        obs.note()


def reset_observer() -> None:
    """Drop the process's observer (tests, a worker's teardown); the next
    commit reads the knob again."""
    global _process_observer
    _process_observer = None


# ---------------------------------------------------------------------------
# the driver's policy
# ---------------------------------------------------------------------------

def _env_get(env: dict | None, name: str) -> str | None:
    """A knob, from ``env`` (the front end's ``extra_env`` overlay, which
    its workers get too) before the process environment."""
    if env:
        for prefix in ("HVD_", "HOROVOD_"):
            v = env.get(prefix + name)
            if v is not None:
                return v
    return envs.get(name)


def _env_int(env, name, default: int) -> int:
    v = _env_get(env, name)
    try:
        return int(v) if v is not None else default
    except ValueError:
        return default


def _env_float(env, name, default: float) -> float:
    v = _env_get(env, name)
    try:
        return float(v) if v is not None else default
    except ValueError:
        return default


def _env_bool(env, name, default: bool = False) -> bool:
    v = _env_get(env, name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


class Decision:
    """One evaluated action, tagged with its round."""

    __slots__ = ("action", "reason", "rank", "round_id", "detail", "t")

    def __init__(self, action: str, reason: str, round_id: int,
                 rank: int | None = None, detail: str = ""):
        self.action = action
        self.reason = reason
        self.rank = rank
        self.round_id = round_id
        self.detail = detail
        self.t = _inv.monotonic()

    def as_dict(self) -> dict:
        return {"action": self.action, "reason": self.reason,
                "rank": self.rank, "round": self.round_id,
                "detail": self.detail, "t": self.t}


class AutoscalePolicy:
    """The driver's controller: sensors in, membership actions out.

    ``driver`` is the :class:`~horovod_tpu_torch.elastic.driver.
    ElasticDriver` (round, rank table, stale grace); ``hosts`` the mutable
    discovery source (:class:`~horovod_tpu_torch.elastic.discovery.
    FixedHosts`: ``add_hosts``, ``remove_host``, ``readmit``) that the
    driver's discovery loop reads, as it reads scripted churn's changes;
    ``kv`` the driver's KV server (read in memory)."""

    def __init__(self, driver, hosts, kv, *, min_np: int,
                 max_np: int | None = None, interval_s: float | None = None,
                 env: dict | None = None):
        self.driver = driver
        self.hosts = hosts
        self.kv = kv
        self.min_np = _env_int(env, envs.AUTOSCALE_MIN, min_np)
        self.max_np = _env_int(
            env, envs.AUTOSCALE_MAX,
            max_np if max_np is not None else min_np)
        self.interval_s = (interval_s if interval_s is not None
                           else _env_float(
                               env, envs.AUTOSCALE_INTERVAL,
                               envs.DEFAULT_AUTOSCALE_INTERVAL_S))
        self.slo_s = _env_float(env, envs.AUTOSCALE_SLO_MS, 0.0) / 1e3
        self.idle_factor = _env_float(
            env, envs.AUTOSCALE_IDLE_FACTOR,
            envs.DEFAULT_AUTOSCALE_IDLE_FACTOR)
        self.breach_windows = max(1, _env_int(
            env, envs.AUTOSCALE_BREACH_WINDOWS,
            envs.DEFAULT_AUTOSCALE_BREACH_WINDOWS))
        self.idle_windows = max(1, _env_int(
            env, envs.AUTOSCALE_IDLE_WINDOWS,
            envs.DEFAULT_AUTOSCALE_IDLE_WINDOWS))
        self.evict_windows = max(1, _env_int(
            env, envs.AUTOSCALE_EVICT_WINDOWS,
            envs.DEFAULT_AUTOSCALE_EVICT_WINDOWS))
        self.cooldown_s = _env_float(
            env, envs.AUTOSCALE_COOLDOWN, envs.DEFAULT_AUTOSCALE_COOLDOWN_S)
        self.grace_s = _env_float(env, envs.AUTOSCALE_GRACE,
                                  envs.DEFAULT_AUTOSCALE_GRACE_S)

        self._breach_streak = 0
        self._idle_streak = 0
        self._blame_rank: int | None = None
        self._blame_streak = 0
        # the recovery-cost sensor over the job's life: re-forms are rare,
        # and a windowed mean would be empty when a remove needs it
        self._restore_s_sum = 0.0
        self._restore_count = 0
        self._cooldown_until = 0.0
        self._last_seq: dict[tuple[int, int], int] = {}
        self._added = 0
        self._evictions = 0
        # the decision log, newest last (tests read it; the registry's
        # counter is the durable record)
        self.decisions: list[Decision] = []
        self.last_decision: Decision | None = None
        self._mu = _inv.make_lock("elastic.policy.mu")
        self._stop = _inv.make_event("elastic.policy.stop")
        self._thread = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = _inv.spawn_thread(self._loop,
                                         name="hvd-autoscale-policy")

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            _inv.join_thread(t, timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    # -- one evaluation window ---------------------------------------------

    def tick(self) -> Decision | None:
        """Evaluate one window; any error is a counted hold."""
        try:
            _faults.inject("policy.eval")
            return self._evaluate()
        except Exception as e:
            err = PolicyEvalError(
                f"autoscale policy evaluation failed ({type(e).__name__}: "
                f"{e}); holding current world")
            hvd_logging.warning("%s", err)
            return self._record(Decision(
                "hold", "error", self._round(), detail=str(e)))

    def _round(self) -> int:
        return self.driver._rendezvous.round_id

    def _read_sensors(self, round_id: int) -> list[dict]:
        """The blobs of ``round_id`` whose sequence moved since the last
        window (a blob of another round names ranks that may have
        renumbered)."""
        for k in [k for k in self._last_seq if k[0] != round_id]:
            del self._last_seq[k]  # rounds only grow
        blobs = []
        for key in self.kv.keys(SENSOR_KEY_PREFIX.rstrip("/")):
            raw = self.kv.get(key)
            if raw is None:
                continue
            try:
                blob = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            if blob.get("round") != round_id:
                continue
            r, seq = int(blob.get("rank", -1)), int(blob.get("seq", 0))
            if seq <= self._last_seq.get((round_id, r), 0):
                continue
            self._last_seq[(round_id, r)] = seq
            blobs.append(blob)
        return blobs

    def _evaluate(self) -> Decision | None:
        now = _inv.monotonic()
        round_id = self._round()
        world = self.driver.world_size()
        blobs = self._read_sensors(round_id)
        if not blobs:
            return None  # nothing fresh: not a window, the streaks hold

        # -- one window's sensors --
        viol_share = 0.0
        steps = sum(b.get("steps", 0) for b in blobs)
        if steps:
            viol_share = sum(b.get("violations", 0)
                             for b in blobs) / steps
        breach = self.slo_s > 0 and viol_share >= 0.5
        idle = (self.slo_s > 0 and len(blobs) >= world and steps > 0
                and all(b.get("violations", 0) == 0
                        and b.get("step_s_mean", 0.0)
                        <= self.idle_factor * self.slo_s
                        and b.get("pending_bytes", 0.0) <= 0.0
                        for b in blobs))
        blames: dict[int, int] = {}
        for b in blobs:
            for r, c in (b.get("straggler") or {}).items():
                blames[int(r)] = blames.get(int(r), 0) + int(c)
        dominant = (max(sorted(blames), key=lambda r: blames[r])
                    if blames else None)
        for b in blobs:
            self._restore_s_sum += float(b.get("restore_s_sum", 0.0))
            self._restore_count += int(b.get("restore_count", 0))

        # -- streaks --
        self._breach_streak = self._breach_streak + 1 if breach else 0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if dominant is not None and dominant == self._blame_rank:
            self._blame_streak += 1
        elif dominant is not None:
            self._blame_rank, self._blame_streak = dominant, 1
        else:
            self._blame_rank, self._blame_streak = None, 0

        if now < self._cooldown_until:
            return None  # the streaks go on; actions wait out the cooldown

        # -- decide: evict, then add, then remove (a straggler inflates
        # the step time, so it is replaced before the world scales) --
        if (self._blame_rank is not None
                and self._blame_streak >= self.evict_windows):
            return self._apply_evict(self._blame_rank, round_id)
        if self._breach_streak >= self.breach_windows:
            if world >= self.max_np:
                return None  # at the ceiling: the breach rides
            return self._apply_add(round_id, viol_share)
        if self._idle_streak >= self.idle_windows:
            if world <= self.min_np:
                return None  # at the floor
            # the brake: every survivor pays the re-form a remove starts;
            # where its measured cost exceeds the idle time the remove
            # would reclaim, shrinking loses throughput
            cost = self._projected_restore_s()
            savings = self.idle_windows * self.interval_s
            if cost > savings:
                return self._record(Decision(
                    "hold", "restore-cost", round_id,
                    detail=f"projected restore {cost:.2f}s exceeds idle "
                           f"savings window {savings:.2f}s"))
            return self._apply_remove(round_id)
        return None

    def _projected_restore_s(self) -> float:
        """The mean measured recovery time (re-form and restore) a rank:
        what the next re-form is projected to cost. Zero until one was
        seen: the first scale-down goes on faith."""
        if self._restore_count <= 0:
            return 0.0
        return self._restore_s_sum / self._restore_count

    # -- actions (the round tag checked again) -----------------------------

    def _stale(self, round_id: int) -> bool:
        return self._round() != round_id

    @contextlib.contextmanager
    def _apply_guard(self, round_id: int):
        """The round check and the host change under the driver's round
        lock, so that no re-form lands between them. The lock is tried,
        never waited for: a ``resume()`` waiting for slots holds it while
        it depends on discovery seeing host changes. Yields None (a
        stale-round hold) where the lock is busy or the round moved, else
        the round."""
        lock = self.driver._round_lock
        if not lock.acquire(blocking=False):
            yield None  # a re-form or resume owns the round now
            return
        try:
            yield None if self._stale(round_id) else round_id
        finally:
            lock.release()

    def _post_action(self) -> None:
        """An action opens the cooldown and resets the streaks: its own
        re-form must not read as the next window's signal."""
        self._cooldown_until = _inv.monotonic() + self.cooldown_s
        self._breach_streak = 0
        self._idle_streak = 0
        self._blame_rank, self._blame_streak = None, 0

    def _new_host(self, slots: int | None, exclude=()) -> dict[str, int]:
        """One host to bring in: a host taken out earlier (its own slots
        where ``slots`` is None; else ``slots``, from a host of at least
        as many), else ``auto<N>`` (one slot where ``slots`` is None)."""
        readmit = getattr(self.hosts, "readmit", None)
        back = (readmit(1, exclude=exclude, min_slots=slots or 1)
                if readmit is not None else {})
        if back:
            host, own = next(iter(back.items()))
            return {host: own if slots is None else slots}
        host = f"auto{self._added}"
        self._added += 1
        return {host: 1 if slots is None else slots}

    def _apply_add(self, round_id: int, viol_share: float) -> Decision:
        with self._apply_guard(round_id) as tag:
            if tag is None:
                return self._record(
                    Decision("hold", "stale-round", round_id))
            new = self._new_host(None)
            self.hosts.add_hosts(new)
        host = next(iter(new))
        self._post_action()
        return self._record(Decision(
            "add", "slo-breach", round_id,
            detail=f"+{host} (violation share {viol_share:.2f})"))

    def _victim_host(self) -> tuple[str, int] | None:
        """``(hostname, slots)`` of the newest (highest-rank) host, never
        rank 0's, which holds the committed state the re-form broadcasts
        from. Removing a host removes all its ranks."""
        slots = self.driver._rank_assignments
        if not slots:
            return None
        host = slots[max(slots)].hostname
        members = [s for s in slots.values() if s.hostname == host]
        if any(s.rank == 0 for s in members):
            return None
        return host, len(members)

    def _apply_remove(self, round_id: int) -> Decision:
        with self._apply_guard(round_id) as tag:
            if tag is None:
                return self._record(
                    Decision("hold", "stale-round", round_id))
            victim = self._victim_host()
            if victim is None:
                return self._record(Decision(
                    "hold", "protected", round_id,
                    detail="no removable host"))
            host, nslots = victim
            if self.driver.world_size() - nslots < self.min_np:
                # a host of several slots would go through the floor
                return self._record(Decision(
                    "hold", "protected", round_id,
                    detail=f"removing {host} ({nslots} slots) would "
                           f"break the {self.min_np} floor"))
            self.driver.set_stale_grace(host, self.grace_s)
            self.hosts.remove_host(host)
        self._post_action()
        return self._record(Decision("remove", "idle", round_id,
                                     detail=f"-{host} (graceful)"))

    def _apply_evict(self, rank: int, round_id: int) -> Decision:
        """The blamed rank's host leaves gracefully (grace window, no step
        lost) while a replacement with as many slots joins in the same
        discovery tick: the world re-forms once at the same size."""
        with self._apply_guard(round_id) as tag:
            if tag is None:
                return self._record(Decision("hold", "stale-round",
                                             round_id, rank=rank))
            slots = self.driver._rank_assignments
            slot = slots.get(rank)
            if slot is None or not self.driver.has_rank_assignment(
                    slot.hostname, slot.local_rank):
                # the blamed rank left between the windows and now: a
                # stale blame never evicts the rank that took its number
                self._blame_rank, self._blame_streak = None, 0
                return self._record(Decision(
                    "hold", "stale-round", round_id, rank=rank,
                    detail="blamed rank not assigned"))
            members = [s for s in slots.values()
                       if s.hostname == slot.hostname]
            if any(s.rank == 0 for s in members):
                # rank 0's host holds the committed state; the blame streak
                # is dropped, so the breach and idle rules act later
                self._blame_rank, self._blame_streak = None, 0
                return self._record(Decision(
                    "hold", "protected", round_id, rank=rank,
                    detail="refusing to evict rank 0's host"))
            new = self._new_host(len(members), exclude=(slot.hostname,))
            self._evictions += 1
            self.driver.set_stale_grace(slot.hostname, self.grace_s)
            self.hosts.remove_host(slot.hostname)
            self.hosts.add_hosts(new)
        self._post_action()
        return self._record(Decision(
            "evict", "straggler", round_id, rank=rank,
            detail=f"-{slot.hostname} +{next(iter(new))}"))

    # -- recording ----------------------------------------------------------

    def _record(self, d: Decision) -> Decision:
        _metrics.ELASTIC_POLICY_DECISIONS.inc(labels={
            "action": d.action, "reason": d.reason,
            "rank": "" if d.rank is None else str(d.rank)})
        _timeline.record_health_event(
            f"AUTOSCALE.{d.action}.{d.reason}")
        with self._mu:
            self.decisions.append(d)
            del self.decisions[:-512]  # the registry keeps the count
            self.last_decision = d
        log = (hvd_logging.warning if d.reason == "error"
               else hvd_logging.info)
        log("autoscale: %s (%s)%s round=%d %s", d.action, d.reason,
            f" rank={d.rank}" if d.rank is not None else "", d.round_id,
            d.detail)
        return d

    def policy_stats(self) -> dict:
        """The controller's state: world, bounds, streaks, cooldown and
        the decision log."""
        with self._mu:
            return {
                "world": self.driver.world_size(),
                "bounds": (self.min_np, self.max_np),
                "breach_streak": self._breach_streak,
                "idle_streak": self._idle_streak,
                "blame": (self._blame_rank, self._blame_streak),
                "cooldown_remaining_s": max(
                    0.0, self._cooldown_until - _inv.monotonic()),
                "decisions": [d.as_dict() for d in self.decisions],
            }


def maybe_start(driver, hosts, kv, *, min_np: int,
                max_np: int | None = None,
                env: dict | None = None) -> AutoscalePolicy | None:
    """Start the policy of an elastic front end where ``HVD_AUTOSCALE`` is
    on (in the process environment or the front end's ``env`` overlay)
    and the discovery source can change; the caller owns ``stop()``. A
    discovery that cannot change (a script's) warns and runs without a
    policy, as scripted churn does."""
    if not _env_bool(env, envs.AUTOSCALE, False):
        return None
    if hosts is None or not hasattr(hosts, "add_hosts"):
        hvd_logging.warning(
            "HVD_AUTOSCALE=1 but the discovery source is not mutable "
            "(FixedHosts is); the autoscale policy is off for this job")
        return None
    policy = AutoscalePolicy(driver, hosts, kv, min_np=min_np,
                             max_np=max_np, env=env)
    policy.start()
    return policy
