"""Bounded exponential backoff for the KV client and the health watchdog
(port of ``horovod_tpu/utils/retry.py``).

Knobs, at the reference's defaults:

* ``HVD_RETRY_MAX_ATTEMPTS`` (5): attempts per :func:`call`;
* ``HVD_RETRY_BACKOFF_MS`` (50): the backoff before the first retry;
* ``HVD_RETRY_MAX_BACKOFF_MS`` (2000): the cap of its doubling;
* ``HVD_RETRY_JITTER`` (0.25): each backoff is scaled by a deterministic
  factor in ``[1-j, 1+j]`` from ``zlib.crc32(site, attempt)``, the same
  on every run, different between sites.

Every retry counts in ``hvd_retry_retries_total{site=...}`` and drops a
``RETRY`` instant on the timeline; a retryable failure that runs out of
attempts counts in ``hvd_retry_giveups_total`` (``metrics.py``; both back
``health_stats()["retries"]``).
"""

from __future__ import annotations

import time
import zlib

from . import envs
from . import logging as hvd_logging


def _metrics():
    from .. import metrics
    return metrics


def stats() -> dict:
    """Per site ``{"retries": n, "giveups": n}``."""
    m = _metrics()
    out: dict[str, dict[str, int]] = {}
    for inst, kind in ((m.RETRY_RETRIES, "retries"),
                       (m.RETRY_GIVEUPS, "giveups")):
        for labelitems, v in inst.series().items():
            site = dict(labelitems)["site"]
            out.setdefault(site, {"retries": 0, "giveups": 0})[kind] = int(v)
    return out


def reset_stats() -> None:
    m = _metrics()
    m.RETRY_RETRIES.reset()
    m.RETRY_GIVEUPS.reset()


def _jitter_factor(what: str, attempt: int) -> float:
    """Deterministic factor in [1-j, 1+j]: the same schedule every run,
    but two sites retrying in lockstep do not thunder in phase."""
    j = envs.get_float(envs.RETRY_JITTER, envs.DEFAULT_RETRY_JITTER)
    if j <= 0.0:
        return 1.0
    h = zlib.crc32(f"{what}:{attempt}".encode()) & 0xFFFFFFFF
    return 1.0 + j * (2.0 * (h / float(1 << 32)) - 1.0)


def backoff_s(what: str, attempt: int) -> float:
    """The sleep before retry ``attempt`` (1-based): jittered
    ``BACKOFF_MS * 2^(attempt-1)``, capped at ``MAX_BACKOFF_MS``."""
    base = envs.get_float(envs.RETRY_BACKOFF_MS,
                          envs.DEFAULT_RETRY_BACKOFF_MS) / 1e3
    cap = envs.get_float(envs.RETRY_MAX_BACKOFF_MS,
                         envs.DEFAULT_RETRY_MAX_BACKOFF_MS) / 1e3
    return min(base * 2.0 ** (attempt - 1), cap) * _jitter_factor(what,
                                                                  attempt)


def max_attempts() -> int:
    return max(envs.get_int(envs.RETRY_MAX_ATTEMPTS,
                            envs.DEFAULT_RETRY_MAX_ATTEMPTS), 1)


def call(fn, *, what: str, retry_on=None, attempts: int | None = None,
         deadline_s: float | None = None):
    """Run ``fn()``, retrying a failure that ``retry_on`` calls transient
    (a predicate, a tuple of exception types, or None: any
    ``Exception``) up to ``attempts`` (default ``HVD_RETRY_MAX_ATTEMPTS``)
    times, or until the next backoff would pass ``deadline_s`` from the
    first call; the last failure re-raises unchanged."""
    n = attempts if attempts is not None else max_attempts()
    end = None if deadline_s is None else time.monotonic() + deadline_s
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as exc:
            if callable(retry_on):
                retryable = retry_on(exc)
            elif retry_on is not None:
                retryable = isinstance(exc, retry_on)
            else:
                retryable = True
            delay = backoff_s(what, attempt)
            if (not retryable or attempt >= n
                    or (end is not None
                        and time.monotonic() + delay > end)):
                if retryable:
                    _metrics().RETRY_GIVEUPS.inc(labels={"site": what})
                raise
            _metrics().RETRY_RETRIES.inc(labels={"site": what})
            from .. import timeline
            timeline.record_retry(what, attempt)
            hvd_logging.debug("retry %d of %s: %s", attempt, what, exc)
            time.sleep(delay)


def poll_intervals(what: str, *, interval_s: float,
                   deadline_s: float | None = None):
    """Jittered pacing for a wait loop: yields after each sleep, the
    interval growing 1.5x a time up to 8x the first, until ``deadline_s``
    has passed."""
    end = None if deadline_s is None else time.monotonic() + deadline_s
    cap, cur, attempt = 8.0 * interval_s, interval_s, 0
    while True:
        attempt += 1
        delay = cur * _jitter_factor(what, attempt)
        if end is not None:
            remaining = end - time.monotonic()
            if remaining <= 0:
                return
            delay = min(delay, remaining)
        time.sleep(delay)
        yield attempt
        cur = min(cur * 1.5, cap)
