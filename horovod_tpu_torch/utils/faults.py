"""Deterministic, spec-driven fault injection (``HVD_FAULT_SPEC``; port of
``horovod_tpu/utils/faults.py``).

Named injection points in the negotiation path fire from a seeded spec, so
a chaos test reproduces the same faults on every run. The grammar
(semicolon-separated rules)::

    HVD_FAULT_SPEC = "site:action[:key=value]..."  [";" more rules]

    kv.put:error:p=0.2:seed=7        # 20 % of KV PUTs raise FaultInjected
    svc.exchange:delay=0.05:rank=2   # rank 2's negotiation rounds sleep
    svc.submit:crash:rank=1:after=5  # rank 1 exits at its sixth submission
    worker:crash:rank=1:at_step=5    # rank 1 exits at its fifth commit
    worker:remove:rank=1:at_step=3   # rank 1's host leaves the job

* **site**: ``kv.put``, ``kv.get``, ``kv.delete``, ``kv.gather`` (the
  ``KVClient`` verbs), ``svc.submit`` (a negotiated collective's
  submission), ``svc.exchange`` (one negotiation round), ``worker`` (an
  elastic ``State.commit``), ``worker.launch`` (the elastic driver
  spawning a worker) and ``policy.eval`` (one evaluation window of the
  autoscale policy, where an error must give a counted ``hold``, never a
  failed job); a trailing ``*`` matches a prefix (``kv.*``).
* **action**: ``error`` (raise :class:`FaultInjected`), ``crash``
  (``os._exit``, code ``code=N``, default 1), ``delay=<seconds>``, or, at
  the ``worker`` site only, a **membership action** of elastic churn:
  ``add`` (``count=K`` fresh hosts join discovery), ``remove`` (the firing
  rank's host leaves discovery; the driver reclaims it abruptly) and
  ``preempt`` (the firing rank drains its queued collectives at the
  commit, its host leaves discovery, and the driver grants it
  ``grace=S`` seconds, 30 by default, to exit through the slot-lost path).
  They run through the handler installed with
  :func:`set_membership_handler` (in a worker, ``elastic.run`` installs
  one that sends them to the driver over the KV store); with none they
  are logged and dropped. They fire once unless ``times=`` says more.
* **filters**: ``p=<0..1>`` fire probability, drawn from ``seed=``;
  ``after=N`` skips the first N matching calls; ``times=N`` fires at most
  N times; ``rank=R`` fires on the process of launcher rank R only;
  ``at_step=S`` at the S-th ``State.commit``; ``at_round=R`` in elastic
  round R (``HVD_ELASTIC_ROUND``).

The probability draw hashes ``(seed, site, call index)`` through
``zlib.crc32``, so a fixed seed fires the same calls on every run and
every rank. With no spec, :func:`inject` is one attribute read.
"""

from __future__ import annotations

import os
import threading
import time
import zlib

from . import envs


class FaultInjected(RuntimeError):
    """An injected fault fired at ``site`` (only a parsed
    ``HVD_FAULT_SPEC`` makes one)."""

    def __init__(self, site: str, rule: str):
        super().__init__(
            f"injected fault at {site!r} (HVD_FAULT_SPEC rule {rule!r})")
        self.site = site
        self.rule = rule


class FaultSpecError(ValueError):
    """``HVD_FAULT_SPEC`` could not be parsed."""


_ACTIONS = ("error", "crash", "delay")
# elastic churn, legal at the `worker` site only (the commit boundary)
_MEMBERSHIP_ACTIONS = ("add", "remove", "preempt")


class _Rule:
    __slots__ = ("site", "action", "delay_s", "exit_code", "p", "seed",
                 "after", "times", "rank", "at_step", "at_round", "count",
                 "grace_s", "text", "calls", "fires")

    def __init__(self, text: str):
        self.text = text
        parts = text.split(":")
        if len(parts) < 2:
            raise FaultSpecError(
                f"fault rule {text!r}: expected 'site:action[:key=value]...'")
        self.site = parts[0].strip()
        if not self.site:
            raise FaultSpecError(f"fault rule {text!r}: empty site")
        action = parts[1].strip()
        self.delay_s = 0.0
        if action.startswith("delay="):
            self.action = "delay"
            try:
                self.delay_s = float(action[len("delay="):])
            except ValueError:
                raise FaultSpecError(
                    f"fault rule {text!r}: bad delay value "
                    f"{action[len('delay='):]!r}") from None
        elif action in ("error", "crash"):
            self.action = action
        elif action in _MEMBERSHIP_ACTIONS:
            if self.site != "worker":
                raise FaultSpecError(
                    f"fault rule {text!r}: membership action {action!r} is "
                    "only legal at the 'worker' site (the commit boundary)")
            self.action = action
        else:
            raise FaultSpecError(
                f"fault rule {text!r}: unknown action {action!r} "
                f"(expected one of {_ACTIONS + _MEMBERSHIP_ACTIONS}, "
                "delay as 'delay=<seconds>')")
        self.exit_code = 1
        self.p = 1.0
        self.seed = 0
        self.after = 0
        self.times: int | None = (
            1 if self.action in _MEMBERSHIP_ACTIONS else None)
        self.rank: int | None = None
        self.at_step: int | None = None
        self.at_round: int | None = None
        self.count = 1  # add: hosts to add
        self.grace_s = 30.0  # preempt: the driver's grace for the worker
        setters = {"p": ("p", float), "seed": ("seed", int),
                   "after": ("after", int), "times": ("times", int),
                   "rank": ("rank", int), "code": ("exit_code", int),
                   "at_step": ("at_step", int), "at_round": ("at_round", int),
                   "count": ("count", int), "grace": ("grace_s", float)}
        for param in parts[2:]:
            key, sep, value = param.partition("=")
            key = key.strip()
            if not sep:
                raise FaultSpecError(
                    f"fault rule {text!r}: parameter {param!r} is not "
                    "key=value")
            if key not in setters:
                raise FaultSpecError(
                    f"fault rule {text!r}: unknown parameter {key!r}")
            attr, cast = setters[key]
            try:
                setattr(self, attr, cast(value))
            except ValueError:
                raise FaultSpecError(
                    f"fault rule {text!r}: bad value for {key!r}: "
                    f"{value!r}") from None
        if not 0.0 <= self.p <= 1.0:
            raise FaultSpecError(
                f"fault rule {text!r}: p={self.p} outside [0, 1]")
        if self.count < 1:
            raise FaultSpecError(
                f"fault rule {text!r}: count={self.count} must be >= 1")
        if self.grace_s < 0:
            raise FaultSpecError(
                f"fault rule {text!r}: grace={self.grace_s} must be >= 0")
        self.calls = 0  # matching calls seen (drives after and the draw)
        self.fires = 0

    def matches_site(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site

    def _draw(self, call_index: int) -> float:
        """A uniform draw in [0, 1) from (seed, site, call index): the
        same on every run and every rank."""
        h = zlib.crc32(f"{self.seed}:{self.site}:{call_index}".encode())
        return (h & 0xFFFFFFFF) / float(1 << 32)

    def should_fire(self, rank: int | None, step: int | None = None,
                    round_id: int | None = None) -> bool:
        """Count a matching call and decide; the caller holds the spec's
        lock."""
        if self.rank is not None and rank != self.rank:
            return False
        if self.at_step is not None and step != self.at_step:
            return False
        if self.at_round is not None and round_id != self.at_round:
            return False
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        if self.p < 1.0 and self._draw(self.calls) >= self.p:
            return False
        self.fires += 1
        return True


class _Spec:
    __slots__ = ("rules", "mu")

    def __init__(self, text: str):
        self.rules = [_Rule(part.strip())
                      for part in text.split(";") if part.strip()]
        if not self.rules:
            raise FaultSpecError(
                f"HVD_FAULT_SPEC {text!r} contains no rules")
        self.mu = threading.Lock()


def parse_spec(text: str) -> list[_Rule]:
    """Parse a spec into rules (raises :class:`FaultSpecError`)."""
    return _Spec(text).rules


def _load() -> _Spec | None:
    text = envs.get(envs.FAULT_SPEC)
    return _Spec(text) if text else None


# None: injection off, the production fast path
_SPEC: _Spec | None = _load()


def active() -> bool:
    return _SPEC is not None


def refresh() -> None:
    """Read ``HVD_FAULT_SPEC`` again. A bad spec raises and leaves
    injection off: a typo fails the chaos run instead of disabling it."""
    global _SPEC
    _SPEC = None
    _SPEC = _load()


def stats() -> dict:
    """Each rule's matching calls and fires, keyed by its text
    (``health_stats()["faults"]``)."""
    spec = _SPEC
    if spec is None:
        return {}
    with spec.mu:
        return {r.text: {"site": r.site, "calls": r.calls, "fires": r.fires}
                for r in spec.rules}


_membership_handler = None


def set_membership_handler(handler) -> None:
    """Install ``handler(action, rule)`` for membership actions; one a
    process."""
    global _membership_handler
    _membership_handler = handler


def clear_membership_handler() -> None:
    global _membership_handler
    _membership_handler = None


def has_membership_rules() -> bool:
    """Whether the spec schedules membership churn."""
    spec = _SPEC
    return spec is not None and any(
        r.action in _MEMBERSHIP_ACTIONS for r in spec.rules)


def _crash(code: int) -> None:
    os._exit(code)


def inject(site: str, *, rank: int | None = None,
           step: int | None = None) -> None:
    """The injection point: nothing unless a rule matches ``site`` and
    its filters; then sleep, raise :class:`FaultInjected`, exit the
    process, or hand a membership action to the handler. ``rank``
    defaults to the launcher's rank of this process; ``step`` is the
    caller's commit count, for ``at_step``."""
    spec = _SPEC
    if spec is None:
        return
    if rank is None:
        rank = envs.launcher_rank()
    round_id = None
    if any(r.at_round is not None for r in spec.rules):
        r = envs.get_int(envs.ELASTIC_ROUND, -1)
        round_id = r if r >= 0 else None
    fired = None
    with spec.mu:
        for rule in spec.rules:
            if rule.matches_site(site) and rule.should_fire(rank, step,
                                                            round_id):
                fired = rule
                break
    if fired is None:
        return
    from .. import metrics
    metrics.FAULT_FIRES.inc(labels={"site": site})
    if fired.action == "delay":
        time.sleep(fired.delay_s)
    elif fired.action == "crash":
        _crash(fired.exit_code)
    elif fired.action in _MEMBERSHIP_ACTIONS:
        handler = _membership_handler
        if handler is None:
            from . import logging as hvd_logging
            hvd_logging.warning(
                "membership fault %r fired with no churn handler "
                "installed; ignoring", fired.text)
            return
        handler(fired.action, fired)
    else:
        raise FaultInjected(site, fired.text)
