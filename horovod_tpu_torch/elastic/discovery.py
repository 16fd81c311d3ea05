"""Host discovery and blacklist management of an elastic job (port of
``horovod_tpu/elastic/discovery.py``).

A pluggable :class:`HostDiscovery` source (a script, or a fixed set), the
blacklist state of each host with an exponential-backoff cooldown and
resurrection, and a :class:`HostManager` that diffs successive discoveries
into :class:`~horovod_tpu_torch.elastic.state.HostUpdateResult` updates
while it keeps a stable host order (oldest hosts first, so rank 0 stays on
a host that holds committed state).

:class:`ScriptedChurn` turns the ``HVD_FAULT_SPEC`` membership actions
into changes of a :class:`FixedHosts` set. A rank is a process here: the
action fires in a worker's ``State.commit`` and reaches the driver's
churn over the launcher's KV store (:class:`KVChurnRelay`, the
``elastic/churn/`` keys of ``driver.py``).
"""

from __future__ import annotations

import itertools
import json
import random
import threading
import time

from ..runner import safe_exec
from ..utils import logging as hvd_logging
from .state import HostUpdateResult

# Bounds of the blacklist cooldown backoff (reference Horovod's).
COOLDOWN_LOWER_LIMIT_S = 1
COOLDOWN_UPPER_LIMIT_S = 60 * 60


class HostState:
    """Blacklist and cooldown state of one host."""

    def __init__(self, cooldown_range: tuple[float, float] | None = None):
        self._event = threading.Event()
        self._blacklisted = False
        self._blacklist_count = 0
        if cooldown_range:
            lo, hi = cooldown_range
            if lo < COOLDOWN_LOWER_LIMIT_S:
                raise ValueError(
                    f"cooldown lower limit {lo} below minimum "
                    f"{COOLDOWN_LOWER_LIMIT_S}")
            if hi > COOLDOWN_UPPER_LIMIT_S:
                raise ValueError(
                    f"cooldown upper limit {hi} above maximum "
                    f"{COOLDOWN_UPPER_LIMIT_S}")
            self._cooldown_lo, self._cooldown_hi = lo, hi
        else:
            self._cooldown_lo = self._cooldown_hi = -1.0
        self._cooldown_end_ts = 0.0

    def get_event(self) -> threading.Event:
        if self._event.is_set():
            self._event = threading.Event()
        return self._event

    def set_event(self) -> None:
        self._event.set()

    def _in_cooldown(self, now: float) -> bool:
        return self._cooldown_end_ts > now

    def blacklist(self) -> None:
        """Blacklist the host and start (or extend) its cooldown."""
        self._blacklisted = True
        now = time.time()
        if self._in_cooldown(now):
            return
        if self._cooldown_lo > 0:
            self._blacklist_count += 1
            # exponential backoff with jitter, clamped to the range
            delay = (self._cooldown_lo * (1 << self._blacklist_count)
                     + random.uniform(0, 1) * self._cooldown_lo)
            delay = max(self._cooldown_lo, min(self._cooldown_hi, delay))
            self._cooldown_end_ts = now + delay
        self.set_event()

    def whitelist(self) -> None:
        """End the cooldown and clear the blacklist flag."""
        self._cooldown_end_ts = 0.0
        self._blacklisted = False

    def is_blacklisted(self) -> bool:
        return self._blacklisted

    def is_resurrected(self) -> bool:
        """Blacklisted host whose cooldown expired: eligible to rejoin."""
        if self._cooldown_end_ts > 0:
            return not self._in_cooldown(time.time())
        return False


class DiscoveredHosts:
    """A snapshot of one discovery result."""

    def __init__(self, host_slots: dict[str, int],
                 host_assignment_order: list[str]):
        self._host_slots = dict(host_slots)
        self._host_assignment_order = list(host_assignment_order)

    @property
    def host_slots(self) -> dict[str, int]:
        return self._host_slots

    @property
    def available_hosts(self) -> set[str]:
        return set(self._host_assignment_order)

    @property
    def host_assignment_order(self) -> list[str]:
        return self._host_assignment_order

    def get_slots(self, host: str) -> int:
        return self._host_slots.get(host, 0)

    def count_available_slots(self) -> int:
        return sum(self.get_slots(h) for h in self._host_assignment_order)

    def update(self, hosts_state) -> "DiscoveredHosts":
        self._host_assignment_order = [
            h for h in self._host_assignment_order
            if not hosts_state[h].is_blacklisted()]
        return self

    def __str__(self):
        return (f"slots: {self._host_slots} "
                f"order: {self._host_assignment_order}")


class HostManager:
    """Tracks the host set as it changes, and its blacklist."""

    def __init__(self, discovery: "HostDiscovery",
                 cooldown_range: tuple[float, float] | None = None):
        self._current_hosts = DiscoveredHosts({}, [])
        self._hosts_state: dict[str, HostState] = {}
        self._cooldown_range = cooldown_range
        self._discovery = discovery

    def _state(self, host: str) -> HostState:
        if host not in self._hosts_state:
            self._hosts_state[host] = HostState(self._cooldown_range)
        return self._hosts_state[host]

    def update_available_hosts(self) -> HostUpdateResult:
        """Run one discovery and diff it against the previous snapshot."""
        prev_slots = self._current_hosts.host_slots
        prev_order = self._current_hosts.host_assignment_order
        host_slots = self._discovery.find_available_hosts_and_slots()

        resurrected = [h for h in host_slots if self._state(h).is_resurrected()]
        if prev_slots == host_slots and not resurrected:
            return HostUpdateResult.no_update

        res = HostUpdateResult.no_update
        for h in prev_slots:
            if h not in host_slots:
                res |= HostUpdateResult.removed
        for h, n in host_slots.items():
            if h not in prev_slots:
                res |= HostUpdateResult.added
            elif n > prev_slots[h]:
                res |= HostUpdateResult.added
            elif n < prev_slots[h]:
                res |= HostUpdateResult.removed
            elif self._state(h).is_resurrected():
                res |= HostUpdateResult.added

        available = {h for h in host_slots
                     if not (self._state(h).is_blacklisted()
                             and not self._state(h).is_resurrected())}
        order = self.order_available_hosts(available, prev_order)
        self._current_hosts = DiscoveredHosts(host_slots, order)
        for h in resurrected:
            self._state(h).whitelist()
        return res

    @property
    def current_hosts(self) -> DiscoveredHosts:
        return self._current_hosts.update(self._hosts_state_default())

    def _hosts_state_default(self):
        class _Default(dict):
            def __missing__(inner, key):  # noqa: N805
                return self._state(key)
        return _Default()

    def blacklist(self, host: str) -> None:
        if not self._state(host).is_blacklisted():
            hvd_logging.info("blacklisting failing host: %s", host)
        self._state(host).blacklist()

    def is_blacklisted(self, host: str) -> bool:
        return self._state(host).is_blacklisted()

    def has_pending_resurrections(self) -> bool:
        """Any blacklisted host that will become eligible again after its
        cooldown (only possible when a cooldown range is configured)."""
        return any(s.is_blacklisted() and s._cooldown_end_ts > 0
                   for s in self._hosts_state.values())

    def get_host_event(self, host: str) -> threading.Event:
        return self._state(host).get_event()

    @staticmethod
    def order_available_hosts(available_hosts: set[str],
                              prev_order: list[str]) -> list[str]:
        """Preserve relative order so the oldest hosts keep the lowest ranks
        (rank 0 must stay on a host holding committed state)."""
        order = [h for h in prev_order if h in available_hosts]
        known = set(order)
        order.extend(h for h in sorted(available_hosts) if h not in known)
        return order


class HostDiscovery:
    """Interface: return ``{hostname: slots}`` for currently usable hosts."""

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        raise NotImplementedError()


class HostDiscoveryScript(HostDiscovery):
    """Runs a user script printing one ``host[:slots]`` per line (the
    launcher's ``--host-discovery-script``)."""

    def __init__(self, discovery_script: str, default_slots: int = 1):
        self._script = discovery_script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        import io
        buf = io.StringIO()
        code = safe_exec.run(self._script, prefix_output=False,
                             stdout=buf, shell=True)
        if code != 0:
            raise RuntimeError(
                f"host discovery script {self._script!r} failed "
                f"with exit code {code}")
        host_slots: dict[str, int] = {}
        for line in set(buf.getvalue().strip().split("\n")):
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, slots = line.rsplit(":", 1)
                host_slots[host] = int(slots)
            else:
                host_slots[line] = self._default_slots
        return host_slots


class FixedHosts(HostDiscovery):
    """A fixed but settable host set: the launcher's ``-H`` hosts of an
    elastic job, and what scripted churn (:class:`ScriptedChurn`) and the
    autoscale policy change. It remembers the hosts taken out, oldest
    first, so that a later scale-up can bring back a machine that exists
    (:meth:`readmit`)."""

    def __init__(self, host_slots: dict[str, int]):
        self._mu = threading.Lock()
        self._host_slots = dict(host_slots)
        self._removed: list[tuple[str, int]] = []

    def find_available_hosts_and_slots(self) -> dict[str, int]:
        with self._mu:
            return dict(self._host_slots)

    def set(self, host_slots: dict[str, int]) -> None:
        with self._mu:
            self._host_slots = dict(host_slots)

    def add_hosts(self, host_slots: dict[str, int]) -> None:
        """Grow the discovered set (a scale-up)."""
        with self._mu:
            self._host_slots.update(host_slots)
            self._removed = [(h, n) for h, n in self._removed
                             if h not in host_slots]

    def remove_host(self, host: str) -> bool:
        """Shrink the discovered set (a reclaim, preemption or scale-down).
        Returns whether the host was present."""
        with self._mu:
            slots = self._host_slots.pop(host, None)
            if slots is None:
                return False
            self._removed.append((host, slots))
            return True

    def readmit(self, count: int, exclude=(),
                min_slots: int = 1) -> dict[str, int]:
        """Up to ``count`` of the hosts taken out, oldest first, with their
        slots, skipping ``exclude`` and hosts of fewer than ``min_slots``
        slots; they are no longer counted as removed (the caller adds them
        back)."""
        with self._mu:
            back = [(h, n) for h, n in self._removed
                    if h not in exclude and n >= min_slots
                    ][:max(int(count), 0)]
            self._removed = [e for e in self._removed if e not in back]
            return dict(back)


class ScriptedChurn:
    """The ``HVD_FAULT_SPEC`` membership actions as changes of a
    :class:`FixedHosts` set, so that churn is a seeded schedule:

    * ``add``: ``count`` hosts join the set; the driver grows the world at
      its next poll. Hosts that churn or the autoscale policy took out
      come back first, oldest first, with their slots
      (:meth:`FixedHosts.readmit`); then fresh names (``churn0``, ``churn1``,
      ...). A worker is a process here, and a name no machine answers to
      could not be started, where a host that left is a machine that
      exists (the JAX package's loopback ranks are threads, and it mints
      names only).
    * ``remove``: the firing rank's host leaves the set; the driver
      reclaims its worker abruptly when the round re-forms.
    * ``preempt``: the firing rank has drained its queued collectives at
      the commit; the driver gives its host ``grace`` seconds to exit
      through the slot-lost path instead of terminating it mid-collective,
      and then the host leaves the set. The survivors interrupt at the same
      commit by rank 0's broadcast, so no step is lost.

    The driver's KV observer calls :meth:`apply` with what a worker's
    :class:`KVChurnRelay` sent; a handler in the worker's own process (a
    test) is called as ``churn(action, rule)``."""

    def __init__(self, hosts: FixedHosts, *, slots_per_host: int = 1,
                 host_prefix: str = "churn", events: list | None = None):
        from ..utils import invariants as _inv
        self._hosts = hosts
        self._slots = int(slots_per_host)
        self._prefix = host_prefix
        self._driver = None
        self._added = 0
        self._mu = _inv.make_lock("elastic.churn.mu")
        # (monotonic seconds, action, host): the event log a caller may
        # pass in to read after the run
        self.events: list[tuple[float, str, str | None]] = \
            events if events is not None else []

    def attach_driver(self, driver) -> None:
        self._driver = driver

    def __call__(self, action: str, rule) -> None:
        from ..utils import envs
        self.apply(action, envs.get(envs.HOSTNAME), rule.count, rule.grace_s)

    def apply(self, action: str, host: str | None, count: int = 1,
              grace_s: float = 30.0) -> None:
        from .. import metrics as _metrics
        if action == "add":
            back = self._hosts.readmit(count)
            with self._mu:
                minted = count - len(back)
                fresh = {f"{self._prefix}{self._added + i}": self._slots
                         for i in range(minted)}
                self._added += minted
            self._hosts.add_hosts({**back, **fresh})
            hvd_logging.info("scripted churn: +%d host(s) %s", count,
                             sorted(back) + sorted(fresh))
            host = ",".join(sorted(back) + sorted(fresh))
        elif action in ("remove", "preempt"):
            if host is None:
                hvd_logging.warning(
                    "scripted churn: %s fired with no HVD_HOSTNAME", action)
                return
            if action == "preempt" and self._driver is not None:
                self._driver.set_stale_grace(host, grace_s)
            self._hosts.remove_host(host)
            hvd_logging.info("scripted churn: -host %s (%s)", host,
                             "abrupt" if action == "remove"
                             else f"preempt, grace {grace_s:.1f}s")
        else:
            hvd_logging.warning("scripted churn: unknown action %r", action)
            return
        with self._mu:
            self.events.append((time.monotonic(), action, host))
        _metrics.ELASTIC_EVENTS.inc(labels={"kind": action})


class KVChurnRelay:
    """A worker's membership handler: sends each fired action to the
    driver's :class:`ScriptedChurn` over the launcher's KV store. A
    ``preempt`` first drains this rank's queued collectives, so its state
    is committed and its flushes have landed before its host leaves."""

    def __init__(self, kv, hostname: str):
        self._kv = kv
        self._host = hostname
        self._seq = itertools.count()

    def __call__(self, action: str, rule) -> None:
        from .driver import churn_key
        if action == "preempt":
            from ..ops import fusion_cycle
            try:
                fusion_cycle.flush_all("preempt-drain")
            except Exception:
                hvd_logging.exception(
                    "scripted churn: preempt drain failed; continuing")
        payload = {"action": action, "host": self._host,
                   "count": rule.count, "grace": rule.grace_s}
        self._kv.put(churn_key(self._host, next(self._seq)),
                     json.dumps(payload).encode())


def parse_churn(payload: bytes):
    """``(action, host, count, grace_s)`` of a relayed action, or None
    where the record is malformed."""
    try:
        body = json.loads(payload.decode())
        return (str(body["action"]), body.get("host"),
                int(body.get("count", 1)), float(body.get("grace", 30.0)))
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None


def install_scripted_churn(discovery, *, events: list | None = None,
                           warn: bool = False):
    """Wire ``HVD_FAULT_SPEC`` membership rules to ``discovery``: where the
    spec schedules ``worker:add/remove/preempt`` and the discovery set can
    change (:class:`FixedHosts`), return a :class:`ScriptedChurn` for it
    (the caller attaches the driver); else None, warning if asked."""
    from ..utils import faults as _faults
    if not _faults.has_membership_rules():
        return None
    if discovery is None or not hasattr(discovery, "add_hosts"):
        if warn:
            hvd_logging.warning(
                "HVD_FAULT_SPEC schedules membership churn but the "
                "discovery source cannot change (FixedHosts can); the "
                "membership rules do nothing")
        return None
    return ScriptedChurn(discovery, events=events)
