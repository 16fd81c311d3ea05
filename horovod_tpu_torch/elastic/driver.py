"""The elastic driver: host discovery, rounds and the workers' lifecycle
(port of ``horovod_tpu/elastic/driver.py``).

The protocol is a round number that only grows, published through the
launcher's KV store:

1. The discovery thread polls the host set each second. On a change, or
   on a worker failure the registry records, the driver computes the next
   assignment (within ``min_np``/``max_np``, without blacklisted hosts),
   publishes round ``R+1`` (its slot table and a fresh ``MASTER_ADDR``/
   ``MASTER_PORT`` for the new process group's ``TCPStore``), and notifies
   the workers (``elastic/notify``, :data:`NOTIFY_KEY`).
2. Running workers read the notification at their next ``state.commit()``,
   raise :class:`HostsUpdatedInterrupt`, fetch round ``R+1`` and re-form
   their world in place (``rendezvous.py``): the old process group ends, a
   new one is made, the state is synced from the last commit.
3. The driver spawns workers for new slots and terminates those whose slot
   went; a worker that finds its slot gone exits with
   :data:`SLOT_LOST_EXIT_CODE`.

Rank 0 stays on the oldest surviving host (``HostManager``'s order), so
the state sync after a reset always comes from a worker that holds the
committed state.
"""

from __future__ import annotations

import pickle
import random
import threading
import time

from .. import checkpoint as _checkpoint
from ..runner import hosts as hosts_mod
from ..utils import envs
from ..utils import faults as _faults
from ..utils import logging as hvd_logging
from ..utils import retry as _retry
from .discovery import HostManager
from .registration import WorkerStateRegistry
from .state import HostUpdateResult

DISCOVER_HOSTS_FREQUENCY_S = 1.0
DEFAULT_ELASTIC_TIMEOUT_S = 600
# A worker exits with this code when its slot vanished in a resize: a clean,
# expected exit that must be ignored by the registry.
SLOT_LOST_EXIT_CODE = 66

# The KV key layout of the elastic protocol; the driver, the workers'
# rendezvous, the notification poller and the launcher's observer use
# these names (notification.NOTIFY_KEY is the same string)
ROUND_KEY = "elastic/round"
ROUND_SPEC_KEY = "elastic/round/{}"
NOTIFY_KEY = "elastic/notify"
STOP_KEY = "elastic/stop"
READY_KEY_PREFIX = "elastic/ready/"
DONE_KEY_PREFIX = "elastic/done/"
# a worker's membership action for the driver's ScriptedChurn
CHURN_KEY_PREFIX = "elastic/churn/"


def ready_key(round_id: int, host: str, slot: int) -> str:
    return f"{READY_KEY_PREFIX}{round_id}/{host}/{slot}"


def done_key(host: str, slot: int) -> str:
    return f"{DONE_KEY_PREFIX}{host}/{slot}"


def parse_done_key(key: str) -> tuple[str, int] | None:
    """Return (host, slot) if ``key`` records a completed worker, else None.

    Workers PUT this the moment their training function returns, before
    any teardown, so the job's success is decided by the end of training,
    not by an exit code that a teardown racing its peers may spoil."""
    if not key.startswith(DONE_KEY_PREFIX):
        return None
    parts = key[len(DONE_KEY_PREFIX):].split("/")
    if len(parts) != 2:
        return None
    try:
        return parts[0], int(parts[1])
    except ValueError:
        return None


def churn_key(host: str, seq: int) -> str:
    return f"{CHURN_KEY_PREFIX}{host}/{seq}"


def parse_ready_key(key: str) -> tuple[str, int] | None:
    """Return (host, slot) if ``key`` is a readiness record, else None."""
    if not key.startswith(READY_KEY_PREFIX):
        return None
    parts = key[len(READY_KEY_PREFIX):].split("/")
    if len(parts) != 3:
        return None
    _round_id, host, slot = parts
    try:
        return host, int(slot)
    except ValueError:
        return None


def _slot_to_dict(s: hosts_mod.SlotInfo) -> dict:
    return {"hostname": s.hostname, "rank": s.rank, "size": s.size,
            "local_rank": s.local_rank, "local_size": s.local_size,
            "cross_rank": s.cross_rank, "cross_size": s.cross_size}


def slot_from_dict(d: dict) -> hosts_mod.SlotInfo:
    return hosts_mod.SlotInfo(**d)


class ElasticRendezvous:
    """Publishes rounds on the launcher's KV server (reference Horovod's
    ``ElasticRendezvousServer``). A round's spec carries ``coord_addr`` and
    ``coord_port``: the ``MASTER_ADDR``/``MASTER_PORT`` of its process
    group, fresh each round."""

    def __init__(self, kv_server):
        self.kv = kv_server
        self._round = 0

    @property
    def round_id(self) -> int:
        return self._round

    def publish_round(self, slots: list[hosts_mod.SlotInfo],
                      coord_addr: str, coord_port: int,
                      update_res: HostUpdateResult) -> int:
        self._round += 1
        spec = {
            "round": self._round,
            "coord_addr": coord_addr,
            "coord_port": coord_port,
            "world_size": len(slots),
            "slots": [_slot_to_dict(s) for s in slots],
        }
        # a new round makes the checkpoint shard hand-offs of the last one
        # stale: a transfer cut by this very churn is not the re-run's
        self.kv.delete(_checkpoint.PEER_KEY_PREFIX.rstrip("/"))
        # workers wait on ROUND_KEY: the spec is readable before the round
        # number moves
        self.kv.put(ROUND_SPEC_KEY.format(self._round), pickle.dumps(spec))
        self.kv.put(ROUND_KEY, str(self._round).encode())
        if self._round > 1:
            # the round id is the notification's timestamp: strictly
            # increasing, so back-to-back rounds never collide
            self.kv.put(NOTIFY_KEY,
                        pickle.dumps((self._round, int(update_res))))
        return self._round

    def stop(self) -> None:
        self.kv.put(STOP_KEY, b"1")


class Results:
    def __init__(self, error_message, worker_results):
        self.error_message = error_message
        self.worker_results = worker_results


class ElasticDriver:
    """Drives an elastic job (reference Horovod's ``ElasticDriver``)."""

    def __init__(self, rendezvous: ElasticRendezvous, discovery,
                 min_np: int, max_np: int | None = None,
                 timeout: float | None = None, reset_limit: int | None = None,
                 cooldown_range=None, verbose: int = 0,
                 remote_port_probe=None):
        self._rendezvous = rendezvous
        # Optional callable(host) -> free port on that host (over ssh);
        # falls back to a random pick when absent or failing.
        self._remote_port_probe = remote_port_probe
        self._host_manager = HostManager(discovery, cooldown_range)
        self._min_np = min_np
        self._max_np = max_np
        self._verbose = verbose
        self._timeout = timeout or envs.get_int(
            envs.ELASTIC_TIMEOUT, DEFAULT_ELASTIC_TIMEOUT_S)

        self._host_assignments: dict[str, list[hosts_mod.SlotInfo]] = {}
        self._rank_assignments: dict[int, hosts_mod.SlotInfo] = {}
        self._world_size = 0

        self._wait_hosts_cond = threading.Condition()
        # host -> grace seconds for the NEXT time its worker goes stale
        # (scripted preemption: the departing worker drains + exits via
        # the slot-lost path inside the window instead of being torn
        # down mid-collective). HVD_ELASTIC_GRACE is the default for
        # hosts without an explicit entry (0 = today's immediate kill).
        self._stale_grace: dict[str, float] = {}
        # Serializes round transitions: _activate_workers can be entered from
        # the discovery thread (host change) and from worker-exit waiter
        # threads (registry resume) concurrently; rounds must be atomic.
        self._round_lock = threading.RLock()
        self._create_worker_fn = None
        self._active_procs: dict[tuple[str, int], object] = {}
        self._proc_lock = threading.Lock()
        self._success = False

        # Host updates that arrived while a round transition held
        # _round_lock; only touched by the discovery thread.
        self._deferred_update = HostUpdateResult.no_update

        self._worker_registry = WorkerStateRegistry(
            self, self._host_manager, reset_limit=reset_limit)
        self._error_message: str | None = None
        self._worker_results: dict[str, tuple[int, float]] = {}
        self._result_threads: list[threading.Thread] = []
        self._shutdown = threading.Event()

        self._discovery_thread = threading.Thread(
            target=self._discover_hosts, daemon=True, name="hvd-elastic-disco")
        self._discovery_thread.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self, np: int, create_worker_fn) -> None:
        """Begin the job: wait for ``np`` slots and launch the first round.

        ``create_worker_fn(slot_info, round_spec)`` must spawn the worker
        process and return a handle with ``wait()/poll()/terminate()``.
        """
        self._create_worker_fn = create_worker_fn
        self._activate_workers(np)

    def resume(self) -> None:
        """Start a new round after failures/blacklisting (registry hook).
        A late failure record landing after the job already stopped
        (e.g. a scripted-churn host's watchdog report racing success
        teardown) must not resurrect the round machinery — resuming a
        shut-down job raised from wait_for_available_slots and turned a
        finished job into an error."""
        if self._shutdown.is_set():
            hvd_logging.debug("ignoring resume after shutdown")
            return
        self._activate_workers(self._min_np)

    def stop(self, error_message: str | None = None,
             success: bool = False) -> None:
        if error_message:
            self._error_message = error_message
        if success:
            self._success = True
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        self._rendezvous.stop()
        with self._wait_hosts_cond:
            self._wait_hosts_cond.notify_all()
        if not success:
            # Failure: tear everything down now. On success, workers are
            # left to exit naturally (they may still be saving checkpoints
            # or running post-training work after recording done);
            # ``join`` terminates stragglers after a grace period.
            self._terminate_active()

    def _terminate_active(self) -> None:
        with self._proc_lock:
            procs = list(self._active_procs.values())
        for p in procs:
            if p.poll() is None:
                p.terminate()

    def finished(self) -> bool:
        return self._shutdown.is_set()

    GRACE_PERIOD_S = 60.0

    def join(self) -> None:
        """Block until the job stops and all exit handlers ran. After a
        success-stop, workers get :data:`GRACE_PERIOD_S` to finish their
        post-training work before stragglers are terminated."""
        while not self._shutdown.wait(0.2):
            pass
        done = False
        with self._proc_lock:
            done = not self._active_procs
        if not done:
            for _ in _retry.poll_intervals("elastic.grace", interval_s=0.2,
                                           deadline_s=self.GRACE_PERIOD_S):
                with self._proc_lock:
                    if not self._active_procs:
                        break
        self._terminate_active()
        for t in list(self._result_threads):
            t.join(timeout=30)
        self._discovery_thread.join(timeout=5)

    def get_results(self) -> Results:
        return Results(self._error_message, dict(self._worker_results))

    @property
    def succeeded(self) -> bool:
        """True when the job stopped because a worker completed successfully
        — failures in *earlier* rounds that elastic recovery absorbed do not
        count against the job."""
        return self._success

    # -- queries ---------------------------------------------------------

    def world_size(self) -> int:
        return self._world_size

    def local_size(self, host: str) -> int:
        return len(self._host_assignments.get(host, []))

    def get_slot_info(self, host: str, slot: int):
        if not self.has_rank_assignment(host, slot):
            return None
        return self._host_assignments[host][slot]

    def get_coordinator_info(self):
        return self._rank_assignments.get(0)

    def has_rank_assignment(self, host: str, slot: int) -> bool:
        if self._host_manager.is_blacklisted(host):
            return False
        return (host in self._host_assignments
                and len(self._host_assignments[host]) > slot)

    @property
    def host_assignments(self):
        return self._host_assignments

    @property
    def registry(self) -> WorkerStateRegistry:
        return self._worker_registry

    def record_ready(self, host: str, slot: int) -> None:
        self._worker_registry.record_ready(host, slot)

    # -- internals ---------------------------------------------------------

    def wait_for_available_slots(self, min_np: int, min_hosts: int = 1):
        deadline = time.monotonic() + self._timeout
        with self._wait_hosts_cond:
            while True:
                current_hosts = self._host_manager.current_hosts
                if (current_hosts.count_available_slots() >= min_np
                        and len(current_hosts.available_hosts) >= min_hosts):
                    return current_hosts
                if self._shutdown.is_set():
                    raise RuntimeError(
                        "job has been shut down, see above errors")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"timed out waiting for at least {min_np} slots "
                        f"on {min_hosts}+ hosts; only "
                        f"{current_hosts.count_available_slots()} available")
                self._wait_hosts_cond.wait(min(remaining, 1.0))

    def _activate_workers(self, min_np: int) -> None:
        with self._round_lock:
            hvd_logging.info("elastic: waiting for %d+ slots", min_np)
            current_hosts = self.wait_for_available_slots(min_np)
            update_res, pending, stale = self._update_host_assignments(
                current_hosts)
            self._worker_registry.reset(self.world_size())
            self._stop_stale_workers(stale)
            self._start_worker_processes(pending)

    def _discover_hosts(self) -> None:
        first_update = True
        while not self._shutdown.is_set():
            with self._wait_hosts_cond:
                try:
                    update_res = self._host_manager.update_available_hosts()
                except Exception as e:
                    # Catch everything: a transiently malformed discovery
                    # output (e.g. ValueError from int()) must not kill the
                    # discovery thread and freeze elasticity.
                    if first_update:
                        hvd_logging.error("initial host discovery failed: %s",
                                          e)
                        self._error_message = str(e)
                        self._shutdown.set()
                        self._wait_hosts_cond.notify_all()
                        return
                    hvd_logging.warning("host discovery failed: %s", e)
                    update_res = HostUpdateResult.no_update
                if update_res != HostUpdateResult.no_update:
                    self._wait_hosts_cond.notify_all()
            pending = update_res | self._deferred_update
            if (pending != HostUpdateResult.no_update and not first_update
                    and self._create_worker_fn is not None):
                self._on_hosts_updated(pending)
            first_update = False
            self._shutdown.wait(DISCOVER_HOSTS_FREQUENCY_S)

    def _on_hosts_updated(self, update_res: HostUpdateResult) -> None:
        """Host set changed mid-run: open a new round if assignments move.

        Runs on the discovery thread; any unexpected error here must stop
        the job loudly rather than silently killing the thread (a dead
        discovery thread would freeze elasticity for the rest of the run).
        """
        # The assignment comparison must run under the round lock: a
        # concurrent registry-driven resume() may be publishing a round for
        # this very host change, and comparing against stale assignments
        # would publish a redundant duplicate round. But the acquire must
        # not block: a resume() parked in wait_for_available_slots (slots <
        # min_np) holds the lock while *depending on this thread* to keep
        # discovering replacement hosts — blocking here would deadlock the
        # scale-down-then-replace scenario. Defer instead and retry on the
        # next discovery tick.
        if not self._round_lock.acquire(blocking=False):
            self._deferred_update |= update_res
            return
        stop_error = None
        try:
            self._deferred_update = HostUpdateResult.no_update
            try:
                current_hosts = self._host_manager.current_hosts
                if current_hosts.count_available_slots() < self._min_np:
                    hvd_logging.warning(
                        "hosts changed but fewer than min_np=%d slots "
                        "available; waiting", self._min_np)
                    return
                try:
                    next_assignments = self._compute_assignments(
                        current_hosts)
                except ValueError as e:
                    hvd_logging.warning("cannot assign hosts yet: %s", e)
                    return
                if {h: [s.rank for s in slots]
                        for h, slots in next_assignments[0].items()} == \
                        {h: [s.rank for s in slots]
                         for h, slots in self._host_assignments.items()}:
                    hvd_logging.debug(
                        "host change does not alter assignments")
                    return
                self._activate_workers(self._min_np)
            except Exception as e:
                hvd_logging.exception("failed to apply host update")
                stop_error = f"host update failed: {e}"
        finally:
            self._round_lock.release()
        if stop_error is not None:
            # stop() tears down worker processes (seconds of grace time per
            # proc) — never do that while holding the round lock.
            self.stop(error_message=stop_error)

    def _compute_assignments(self, current_hosts):
        host_list = [hosts_mod.HostSpec(h, current_hosts.get_slots(h))
                     for h in current_hosts.host_assignment_order]
        assignment_list = hosts_mod.elastic_host_assignments(
            host_list, self._min_np, self._max_np)
        by_host: dict[str, list[hosts_mod.SlotInfo]] = {}
        for slot_info in assignment_list:
            by_host.setdefault(slot_info.hostname, []).append(slot_info)
        return by_host, assignment_list

    def _update_host_assignments(self, current_hosts):
        active = set(self._active_slots())
        by_host, assignment_list = self._compute_assignments(current_hosts)

        if self._host_assignments:
            prev_hosts = set(self._host_assignments)
            if not prev_hosts & set(by_host):
                raise RuntimeError(
                    "no hosts from the previous round remain; committed "
                    "state cannot be broadcast to the new workers")

        prev_world = self._world_size
        self._host_assignments = by_host
        self._rank_assignments = {s.rank: s for s in assignment_list}
        self._world_size = len(assignment_list)

        update_res = HostUpdateResult.no_update
        if self._world_size > prev_world:
            update_res |= HostUpdateResult.added
        if prev_world and self._world_size < prev_world:
            update_res |= HostUpdateResult.removed
        if prev_world and self._world_size == prev_world:
            update_res |= HostUpdateResult.mixed

        coord_host = assignment_list[0].hostname
        coord_addr, coord_port = self._coordinator_endpoint(coord_host)
        self._current_spec_round = self._rendezvous.publish_round(
            assignment_list, coord_addr, coord_port, update_res)

        assigned = {(s.hostname, s.local_rank) for s in assignment_list}
        pending = [s for s in assignment_list
                   if (s.hostname, s.local_rank) not in active]
        stale = [key for key in active if key not in assigned]
        return update_res, pending, stale

    def _coordinator_endpoint(self, coord_host: str) -> tuple[str, int]:
        from ..runner.http_kv import local_addresses
        from ..runner.launch import _free_port, is_local_host
        if is_local_host(coord_host):
            addr = "127.0.0.1" if all(
                is_local_host(h) for h in self._host_assignments) else \
                local_addresses()[0]
            return addr, _free_port()
        # Remote coordinator: ask that host's kernel for a free ephemeral
        # port over ssh; a blind random pick risks a collision that fails
        # the rank-0 worker and blacklists the very host holding committed
        # state. Random fallback only if the probe itself fails.
        if self._remote_port_probe is not None:
            try:
                return coord_host, int(self._remote_port_probe(coord_host))
            except Exception as e:
                hvd_logging.warning(
                    "free-port probe on %s failed (%s); falling back to a "
                    "random port", coord_host, e)
        return coord_host, random.randint(29500, 64000)

    def _active_slots(self):
        with self._proc_lock:
            return list(self._active_procs.keys())

    def set_stale_grace(self, host: str, grace_s: float) -> None:
        """Grant ``host``'s worker a clean-exit window the next time its
        slot disappears (a graceful preemption): the
        worker keeps participating until the host-change interrupt lands
        at its commit boundary and then self-exits slot-lost — so a
        scheduled departure loses zero steps instead of the abrupt
        mid-collective kill's <=1."""
        self._stale_grace[host] = float(grace_s)

    def _stop_stale_workers(self, stale_keys) -> None:
        # a host's grace is for every one of its slots that goes stale now
        # (a host of several slots leaves whole), and is then used up
        graces: dict[str, float] = {}
        for key in stale_keys:
            if key[0] not in graces:
                graces[key[0]] = self._stale_grace.pop(
                    key[0], envs.get_float(envs.ELASTIC_GRACE, 0.0))
        for key in stale_keys:
            with self._proc_lock:
                proc = self._active_procs.get(key)
            if proc is None or proc.poll() is not None:
                continue
            grace = graces[key[0]]
            if grace <= 0:
                hvd_logging.info("terminating worker %s[%d]: slot removed",
                                 *key)
                proc.terminate()
                continue
            hvd_logging.info(
                "worker %s[%d] slot removed; granting %.1fs to exit "
                "cleanly (preemption grace)", key[0], key[1], grace)

            def deferred(proc=proc, key=key, grace=grace):
                for _ in _retry.poll_intervals("elastic.stale-grace",
                                               interval_s=0.2,
                                               deadline_s=grace):
                    if proc.poll() is not None or self._shutdown.is_set():
                        return
                if proc.poll() is None:
                    hvd_logging.warning(
                        "worker %s[%d] did not exit within its %.1fs "
                        "preemption grace; terminating", key[0], key[1],
                        grace)
                    proc.terminate()

            t = threading.Thread(target=deferred, daemon=True,
                                 name=f"hvd-elastic-grace-{key[0]}")
            t.start()
            self._result_threads.append(t)

    def _start_worker_processes(self, pending_slots) -> None:
        spec_round = self._rendezvous.round_id
        for slot_info in pending_slots:
            hvd_logging.info("starting worker %s[%d] (rank %d, round %d)",
                             slot_info.hostname, slot_info.local_rank,
                             slot_info.rank, spec_round)
            self._start_worker_process(slot_info, spec_round)

    def record_peer_failure(self, dead_rank: int, reason: str,
                            round_id: int = -1) -> None:
        """A surviving worker's health watchdog reported ``dead_rank``
        dead (poison/beat-timeout record on the launcher KV, parsed by
        the bootstrap PUT observer): convert the coordinated abort into
        a registry failure so the dead host is blacklisted and
        :meth:`resume` re-forms the round NOW — without waiting for the
        dead process to be reaped by its exit waiter.

        ``round_id`` is the round the REPORTER was in. Global ranks
        renumber every round, so a report from a superseded round must
        be resolved against THAT round's slot table — resolving it
        against the newest one can blacklist an innocent replacement
        worker that inherited the dead rank's number (seen under
        scripted churn: a removed host's watchdog-detected death arrived
        after its slot had already been reassigned)."""
        slot = self._rank_assignments.get(dead_rank)
        current_round = self._rendezvous.round_id
        if round_id >= 0 and round_id != current_round:
            stale_slot = self._slot_in_round(round_id, dead_rank)
            if stale_slot is None or slot is None \
                    or stale_slot.hostname != slot.hostname:
                hvd_logging.info(
                    "ignoring stale peer-failure report for rank %d of "
                    "round %d (now round %d): %s — the host already left "
                    "the assignment", dead_rank, round_id, current_round,
                    reason)
                return
        if slot is None:
            hvd_logging.warning(
                "peer-failure report for unassigned rank %d (%s); ignoring",
                dead_rank, reason)
            return
        hvd_logging.error(
            "worker %s[%d] (rank %d) reported dead by a peer watchdog: %s",
            slot.hostname, slot.local_rank, dead_rank, reason)
        # From a fresh thread, like a process-exit waiter: this is called
        # by the KV server's PUT observer, and the resume() a failure can
        # trigger may block on slot availability — the reporting worker's
        # PUT must not hang on it.
        t = threading.Thread(
            target=self._worker_registry.record_failure,
            args=(slot.hostname, slot.local_rank),
            daemon=True, name=f"hvd-elastic-peerfail-{dead_rank}")
        t.start()
        self._result_threads.append(t)

    def _slot_in_round(self, round_id: int, rank: int):
        """Slot assignment of ``rank`` in a (possibly superseded) round,
        from the published round spec; None when unknown."""
        try:
            raw = self._rendezvous.kv.get(ROUND_SPEC_KEY.format(round_id))
            if raw is None:
                return None
            spec = pickle.loads(raw)
            for s in spec["slots"]:
                if s["rank"] == rank:
                    return slot_from_dict(s)
        except Exception as e:
            hvd_logging.debug("round-%d spec lookup failed: %s", round_id, e)
        return None

    def _start_worker_process(self, slot_info, spec_round: int) -> None:
        try:
            _faults.inject("worker.launch", rank=slot_info.rank)
            proc = self._create_worker_fn(slot_info, spec_round)
        except Exception as e:
            # A failed spawn used to unwind the whole round transition;
            # treat it like an instant worker failure instead — the
            # registry blacklists the host and resumes with the rest.
            # Recorded from a fresh thread, exactly like an exit-waiter
            # thread would, so the (re-entrant) round lock the caller
            # holds is not re-acquired deeper on this stack.
            hvd_logging.error("failed to start worker %s[%d]: %s",
                              slot_info.hostname, slot_info.local_rank, e)
            t = threading.Thread(
                target=self._worker_registry.record_failure,
                args=(slot_info.hostname, slot_info.local_rank),
                daemon=True, name=f"hvd-elastic-spawnfail-{slot_info.rank}")
            t.start()
            self._result_threads.append(t)
            return
        key = (slot_info.hostname, slot_info.local_rank)
        with self._proc_lock:
            self._active_procs[key] = proc

        def waiter():
            exit_code = proc.wait()
            with self._proc_lock:
                if self._active_procs.get(key) is proc:
                    del self._active_procs[key]
            self._handle_worker_exit(slot_info, exit_code)

        t = threading.Thread(target=waiter, daemon=True,
                             name=f"hvd-elastic-wait-{slot_info.rank}")
        t.start()
        self._result_threads.append(t)

    def _handle_worker_exit(self, slot_info, exit_code: int) -> None:
        timestamp = time.time()
        name = f"{slot_info.hostname}[{slot_info.local_rank}]"
        if exit_code == SLOT_LOST_EXIT_CODE:
            hvd_logging.debug("worker %s exited: slot removed", name)
            return
        if not self.has_rank_assignment(slot_info.hostname,
                                        slot_info.local_rank):
            hvd_logging.debug("ignoring exit of unassigned worker %s", name)
            return
        if self.finished() and exit_code != 0:
            # Non-zero exit after the job already stopped is almost always
            # the driver's own SIGTERM during teardown, not a failure.
            hvd_logging.debug("ignoring post-shutdown exit of %s (%d)",
                              name, exit_code)
            return
        self._worker_results.setdefault(name, (exit_code, timestamp))
        if exit_code == 0:
            self._worker_registry.record_success(slot_info.hostname,
                                                 slot_info.local_rank)
        else:
            self._worker_registry.record_failure(slot_info.hostname,
                                                 slot_info.local_rank)
