"""Bounded exponential backoff for the KV client (the part of
``horovod_tpu/utils/retry.py`` that ``runner/http_kv.py`` uses, at the
reference's defaults: 5 attempts, 50 ms doubling to at most 2 s, each
backoff scaled by a deterministic factor in [0.75, 1.25])."""

from __future__ import annotations

import time
import zlib

MAX_ATTEMPTS = 5
BACKOFF_S = 0.05
MAX_BACKOFF_S = 2.0
JITTER = 0.25


def _jitter_factor(what: str, attempt: int) -> float:
    """Deterministic factor in [1-j, 1+j]: the same schedule every run,
    but two sites retrying in lockstep do not thunder in phase."""
    h = zlib.crc32(f"{what}:{attempt}".encode()) & 0xFFFFFFFF
    return 1.0 + JITTER * (2.0 * (h / float(1 << 32)) - 1.0)


def backoff_s(what: str, attempt: int) -> float:
    """The sleep before retry ``attempt`` (1-based)."""
    return (min(BACKOFF_S * 2.0 ** (attempt - 1), MAX_BACKOFF_S)
            * _jitter_factor(what, attempt))


def call(fn, *, what: str, retry_on, deadline_s: float | None = None):
    """Run ``fn()``, retrying a failure that ``retry_on(exc)`` calls
    transient, up to ``MAX_ATTEMPTS`` times or until ``deadline_s`` (from
    the first call) would pass; the last failure re-raises unchanged."""
    end = None if deadline_s is None else time.monotonic() + deadline_s
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as exc:
            delay = backoff_s(what, attempt)
            if (not retry_on(exc) or attempt >= MAX_ATTEMPTS
                    or (end is not None
                        and time.monotonic() + delay > end)):
                raise
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
