"""The worker lifecycle registry of the elastic driver (port of
``horovod_tpu/elastic/registration.py``).

The driver is the one coordinator and reacts to each recorded state at
once, so the registry is a thread-safe state table with reference
Horovod's decisions:

- any worker SUCCESS        -> the job is done, stop everything
- all workers FAILURE       -> the job failed, stop
- some workers FAILURE      -> blacklist their hosts and start a new round
- every recorded host blacklisted -> stop
- reset count over the limit      -> stop
"""

from __future__ import annotations

import threading
from collections import defaultdict

from ..utils import logging as hvd_logging

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"

RESET_LIMIT_EXCEEDED_MESSAGE = (
    "Elastic job failed: reached the reset limit of {} rounds. A reset is "
    "triggered every time a worker fails or the host set changes; raise "
    "--reset-limit or investigate the recurring failures."
)


class WorkerStateRegistry:
    """Records READY / SUCCESS / FAILURE per (host, slot) for the current
    rendezvous round and decides the round transition."""

    def __init__(self, driver, host_manager, reset_limit: int | None = None,
                 verbose: bool = False):
        self._driver = driver
        self._host_manager = host_manager
        self._reset_limit = reset_limit
        self._reset_count = 0
        self._lock = threading.Lock()
        self._states: dict[tuple[str, int], str] = {}
        self._workers: dict[str, set] = defaultdict(set)
        self._rendezvous_id = 0
        self._size = 0
        self._verbose = verbose

    def get_recorded_slots(self):
        with self._lock:
            return list(self._states.keys())

    def get(self, state: str) -> set:
        with self._lock:
            return set(self._workers[state])

    def count(self, state: str) -> int:
        with self._lock:
            return len(self._workers[state])

    def reset(self, size: int) -> None:
        """Start a new rendezvous round expecting ``size`` workers."""
        with self._lock:
            hvd_logging.info("reset workers: %d", size)
            self._states.clear()
            self._workers.clear()
            self._rendezvous_id += 1
            self._size = size

    def size(self) -> int:
        return self._size

    def last_rendezvous(self) -> int:
        return self._rendezvous_id

    @property
    def reset_count(self) -> int:
        return self._reset_count

    def record_ready(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, READY)

    def record_success(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, SUCCESS)

    def record_failure(self, host: str, slot: int) -> int:
        return self._record_state(host, slot, FAILURE)

    def _record_state(self, host: str, slot: int, state: str) -> int:
        if self._driver.finished():
            hvd_logging.info(
                "driver finished, ignoring registration: %s[%d] = %s",
                host, slot, state)
            return self._rendezvous_id
        if self._host_manager.is_blacklisted(host):
            hvd_logging.warning(
                "host %s records %s but is blacklisted, ignoring", host, state)
            return self._rendezvous_id

        key = (host, slot)
        with self._lock:
            prev = self._states.get(key)
            if prev == SUCCESS and state == FAILURE:
                # completion was recorded through the KV done key; a later
                # non-zero exit is teardown noise, not a failure
                hvd_logging.debug(
                    "ignoring FAILURE after SUCCESS for %s[%d]", host, slot)
                return self._rendezvous_id
            if prev is not None and state != FAILURE and prev != state:
                # a worker may go READY -> SUCCESS within one round;
                # FAILURE overrides READY
                if not (prev == READY and state == SUCCESS):
                    hvd_logging.error(
                        "state %s ignored for %s[%d]: already %s",
                        state, host, slot, prev)
                    return self._rendezvous_id
            if prev is not None:
                self._workers[prev].discard(key)
            self._states[key] = state
            self._workers[state].add(key)
            rendezvous_id = self._rendezvous_id

        self._on_state_recorded(state)
        return rendezvous_id

    def _on_state_recorded(self, state: str) -> None:
        """The round-transition decision."""
        if state == READY:
            return  # nothing to decide until a worker terminates

        if self.count(SUCCESS) > 0:
            hvd_logging.info("worker succeeded -> stopping job")
            self._driver.stop(success=True)
            return

        if self._size and self.count(FAILURE) >= self._size:
            hvd_logging.error("all %d workers failed -> stopping job",
                              self._size)
            self._driver.stop()
            return

        for host, _slot in self.get(FAILURE):
            self._host_manager.blacklist(host)

        # blacklisting drained every slot and no cooldown brings one back:
        # the job cannot go on
        current = self._host_manager.current_hosts
        if current.count_available_slots() == 0 \
                and not self._host_manager.has_pending_resurrections():
            hvd_logging.error("no available slots remain -> stopping")
            self._driver.stop()
            return

        if self._reset_limit is not None \
                and self._reset_count >= self._reset_limit:
            self._driver.stop(
                error_message=RESET_LIMIT_EXCEEDED_MESSAGE.format(
                    self._reset_limit))
            return

        self._reset_count += 1
        try:
            self._driver.resume()
        except Exception:
            hvd_logging.exception("failed to activate new hosts -> stopping")
            self._driver.stop()
