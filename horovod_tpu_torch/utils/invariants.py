"""Dev-mode runtime concurrency invariant checker (``HVD_DEBUG_INVARIANTS=1``;
port of ``horovod_tpu/utils/invariants.py``).

The fusion cycle, its pipelined executor, the QoS gate and the step
capture rest on a handful of concurrency invariants: locks are always
taken in one order, executor-private state is only touched from the
executor thread, pending-queue state only mutates under the queue lock,
and a flush execution never re-enters the scheduler's enqueue path on the
same thread. This module checks what threads actually did at run time and
raises :class:`InvariantViolation` at the first divergence, with both
acquisition stacks for a lock-order inversion.

Everything here is off by default: with ``HVD_DEBUG_INVARIANTS`` unset,
:func:`make_lock` / :func:`make_rlock` / :func:`make_condition` return
plain :mod:`threading` primitives and every ``assert_*`` helper returns at
once.

* **Lock-order witness**: tracked locks record, per thread, the stack of
  held locks. The first time lock ``B`` is taken while ``A`` is held, the
  edge ``A -> B`` is recorded with its stack; a later attempt to take
  ``A`` while holding ``B`` (directly or through a chain of recorded
  edges) raises with both stacks before it blocks.
* **Thread-affinity assertions**: :func:`assert_thread` (state owned by
  one thread) and :func:`assert_holding` (state guarded by a lock).
* **Re-entrancy guard**: :func:`section` / :func:`assert_outside`.

Violations raise by default (``raise_on_violation``) and are counted;
:func:`report` returns the counters.

**The constructor seam.** Every lock, condition, event and thread of the
port's concurrency core is made here (:func:`make_event`,
:func:`spawn_thread`, :func:`join_thread`, :func:`sleep`,
:func:`monotonic`), as in the JAX package. Its ``HVD_SCHED_CHECK`` hook,
which hands these to a model checker of the JAX package's modules, is not
ported.
"""

from __future__ import annotations

import threading
import time
import traceback

from . import envs

# Guards the witness's own state (edge graph, violation log). A plain,
# untracked lock: it is only ever taken with no tracked lock operation in
# progress on this thread, never exposed, and never nested.
_state_lock = threading.Lock()

# (held_name, acquired_name) -> formatted stack of the first acquisition
# that created the edge; _adjacent is the same graph keyed for traversal
# (transitive-cycle detection).
_edges: dict[tuple[str, str], str] = {}
_adjacent: dict[str, set[str]] = {}

_violations: list[str] = []
_counts: dict[str, int] = {"lock-order": 0, "thread-affinity": 0,
                           "lock-held": 0, "reentrancy": 0}

raise_on_violation = True

_tls = threading.local()

_MAX_VIOLATIONS = 64  # keep report() bounded under a pathological loop


class InvariantViolation(AssertionError):
    """A dev-mode concurrency invariant was broken. Inherits
    AssertionError so test harnesses treat it as a failed check."""


def _env_enabled() -> bool:
    return envs.get_bool(envs.DEBUG_INVARIANTS)


_ENABLED = _env_enabled()


def enabled() -> bool:
    """Whether the checker is active (cached; see :func:`refresh`)."""
    return _ENABLED


def refresh() -> bool:
    """Re-read ``HVD_DEBUG_INVARIANTS`` (tests toggle it after import).
    Only affects primitives created afterwards and the assert helpers."""
    global _ENABLED
    _ENABLED = _env_enabled()
    return _ENABLED


def reset() -> None:
    """Drop recorded edges, violations, and counters (tests)."""
    with _state_lock:
        _edges.clear()
        _adjacent.clear()
        _violations.clear()
        for k in _counts:
            _counts[k] = 0


def report() -> dict:
    """Counters + the recorded violation messages (bounded)."""
    with _state_lock:
        return {"enabled": _ENABLED, "counts": dict(_counts),
                "violations": list(_violations)}


def _violate(kind: str, message: str) -> None:
    with _state_lock:
        _counts[kind] += 1
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append(f"[{kind}] {message}")
    if raise_on_violation:
        raise InvariantViolation(f"[{kind}] {message}")


# ---------------------------------------------------------------------------
# lock-order witness
# ---------------------------------------------------------------------------

def _held_stack() -> list[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def held_locks() -> tuple[str, ...]:
    """Names of tracked locks the current thread holds, outermost first."""
    return tuple(_held_stack())


def _path(frm: str, to: str) -> list[str] | None:
    """A recorded-edge path ``frm -> ... -> to``, or None. Caller holds
    ``_state_lock``."""
    stack = [(frm, [frm])]
    seen = {frm}
    while stack:
        node, path = stack.pop()
        for nxt in _adjacent.get(node, ()):
            if nxt == to:
                return path + [to]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _check_order(name: str) -> None:
    """Record ``held -> name`` edges; raise BEFORE the caller blocks on
    the inner lock (report the potential deadlock instead of exhibiting
    it) when acquiring ``name`` would close a cycle — including a
    transitive one — in the recorded acquisition-order graph."""
    held = _held_stack()
    if not held:
        return
    for h in held:
        if h == name:
            continue  # re-entrant acquisition of the same (R)Lock
        cycle = None
        with _state_lock:
            if (h, name) not in _edges:
                # adding h -> name closes a cycle iff name already
                # reaches h through recorded edges
                cycle = _path(name, h)
                if cycle is None:
                    here = "".join(traceback.format_stack(limit=16)[:-2])
                    _edges[(h, name)] = here
                    _adjacent.setdefault(h, set()).add(name)
                    continue
                prior = _edges[(cycle[0], cycle[1])]
            else:
                continue
        here = "".join(traceback.format_stack(limit=16)[:-2])
        _violate(
            "lock-order",
            f"acquiring {name!r} while holding {h!r}, but the opposite "
            f"order was recorded earlier: {' -> '.join(cycle)}.\n"
            f"--- earlier acquisition ({cycle[0]!r} then {cycle[1]!r}):\n"
            f"{prior}"
            f"--- current acquisition ({h!r} then {name!r}):\n{here}")


class _TrackedLock:
    """A ``threading.Lock`` that feeds the witness. Duck-types the lock
    protocol (acquire/release/context manager/locked) so it drops into
    ``threading.Condition`` too."""

    _reentrant = False

    def __init__(self, name: str):
        self._name = name
        self._inner = self._make_inner()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        if blocking and not (self._reentrant and self._name in held):
            _check_order(self._name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            held.append(self._name)
        return got

    def release(self) -> None:
        held = _held_stack()
        # remove the innermost occurrence (Condition.wait releases and
        # re-acquires out of strict LIFO order with surrounding locks)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self._name:
                del held[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<{type(self).__name__} {self._name!r}>"


class _TrackedRLock(_TrackedLock):
    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()


def make_lock(name: str):
    """A mutex for ``name``: witness-tracked when the checker is on, a
    plain ``threading.Lock`` otherwise. ``name`` convention: ``module.owner.attr`` (e.g.
    ``fusion_cycle.scheduler.mu``)."""
    return _TrackedLock(name) if _ENABLED else threading.Lock()


def make_rlock(name: str):
    return _TrackedRLock(name) if _ENABLED else threading.RLock()


def make_condition(name: str):
    """A ``threading.Condition`` over a tracked mutex. ``wait()`` releases
    and re-acquires through the tracked lock, so held-lock state stays
    correct across waits."""
    if not _ENABLED:
        return threading.Condition(threading.Lock())
    return threading.Condition(_TrackedLock(name))


def make_event(name: str):
    """A ``threading.Event`` for ``name`` (the witness does not track
    events)."""
    return threading.Event()


def spawn_thread(target, *, name: str, daemon: bool = True,
                 args=(), kwargs=None) -> threading.Thread:
    """Create and start a (daemon) thread."""
    t = threading.Thread(target=target, name=name, daemon=daemon,
                         args=args, kwargs=kwargs or {})
    t.start()
    return t


def join_thread(thread: threading.Thread | None, timeout=None) -> None:
    """``thread.join(timeout)``; None joins nothing."""
    if thread is None:
        return
    thread.join(timeout)


def sleep(seconds: float) -> None:
    """``time.sleep``."""
    time.sleep(seconds)


def monotonic() -> float:
    """``time.monotonic``: the clock of cycle pacing and deadlines."""
    return time.monotonic()


def holding(lock) -> bool:
    """Whether the current thread holds ``lock`` (tracked locks and
    conditions over them only; plain primitives report False)."""
    if isinstance(lock, threading.Condition):
        lock = lock._lock  # the mutex the condition wraps
    name = getattr(lock, "name", None)
    return name is not None and name in _held_stack()


# ---------------------------------------------------------------------------
# assertion helpers (no-ops unless enabled)
# ---------------------------------------------------------------------------

def assert_holding(lock, what: str) -> None:
    """State guarded by ``lock`` is being touched — the current thread
    must hold it. No-op when the checker is off or ``lock`` is a plain
    primitive (created before the checker was enabled)."""
    if not _ENABLED:
        return
    name = getattr(getattr(lock, "_lock", lock), "name", None)
    if name is None:
        return
    if not holding(lock):
        _violate("lock-held",
                 f"{what}: requires lock {name!r}, held: "
                 f"{list(_held_stack())!r} "
                 f"(thread {threading.current_thread().name!r})")


def assert_thread(owner: threading.Thread | None, what: str) -> None:
    """State owned by one thread is being touched — the current thread
    must be ``owner`` (None = owner not running, any thread legal)."""
    if not _ENABLED or owner is None:
        return
    cur = threading.current_thread()
    if cur is not owner:
        _violate("thread-affinity",
                 f"{what}: must run on thread {owner.name!r}, "
                 f"ran on {cur.name!r}")


class section:
    """Re-entrancy guard: ``with section('flush-execute'): ...`` marks the
    region; :func:`assert_outside` raises if the SAME thread is already
    inside it. Always active as a context manager; the bookkeeping is a
    thread-local counter, so the disabled cost is negligible."""

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        depths = getattr(_tls, "sections", None)
        if depths is None:
            depths = _tls.sections = {}
        depths[self._name] = depths.get(self._name, 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.sections[self._name] -= 1
        return False


def inside(name: str) -> bool:
    return bool(getattr(_tls, "sections", {}).get(name))


def assert_outside(name: str, what: str) -> None:
    if not _ENABLED:
        return
    if inside(name):
        _violate("reentrancy",
                 f"{what}: re-entered section {name!r} on thread "
                 f"{threading.current_thread().name!r}")
