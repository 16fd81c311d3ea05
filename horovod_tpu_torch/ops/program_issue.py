"""Serialized, ordered issue of collectives (port of
``horovod_tpu/ops/program_issue.py``).

The pipelined flush executor (``ops/fusion_cycle.py``) issues queued
collectives on a thread of its own, while the user's thread and the
autograd thread issue others: the Ulysses all-to-alls, the MoE exchanges,
the pipeline's sends, Adasum, SyncBatchNorm and the synchronous
collectives. NCCL and gloo pair collectives by the order in which each
rank issues them on a communicator, so in a world of one process a rank
this order must be the same on every rank. Two rules give it:

* one process-wide issue lock (an ``RLock``) is held around every issue,
  so two threads never interleave the launches of two collectives (the
  reference launches every collective on one background thread,
  ``operations.cc:385``);
* :func:`ordered` makes issue order equal to submission order: a
  collective issued outside the cycle first waits until every batch
  submitted to the executor before it has been issued. A batch still
  pending in a queue is not waited for: it is drained at a point of the
  program that is the same on every rank, and issued after.

The lock covers only the issue (the launch of asynchronous work), never a
wait for completion in the executor. The executor itself, and anything
issued from inside a serialized issue, passes through (re-entrant).
"""

from __future__ import annotations

import contextlib

from ..utils import invariants as _inv

_ISSUE_LOCK = _inv.make_rlock("program_issue.issue")


def issue_lock_held() -> bool:
    """Whether the current thread is inside a serialized issue."""
    return _inv.holding(_ISSUE_LOCK) or _inv.inside("program-issue")


@contextlib.contextmanager
def serialized():
    """Hold the issue lock around one issue (the executor's batches)."""
    with _ISSUE_LOCK, _inv.section("program-issue"):
        yield


@contextlib.contextmanager
def ordered():
    """Issue a collective outside the fusion cycle: wait until every batch
    submitted to the flush executor before this point has been issued,
    then hold the issue lock. Inside a serialized issue (the executor's
    own collectives, or a nested call), and inside a negotiation
    service's issue (``DynamicService.run_until``, already in the agreed
    order), it only holds the lock."""
    if not issue_lock_held() and not _inv.inside("svc-issue"):
        from . import fusion_cycle
        sched = fusion_cycle._current_scheduler()
        if sched is not None:
            sched.wait_issued()
    with serialized():
        yield


def issue_serialized(fn):
    """``fn`` wrapped so that concurrent callers issue it whole, in order
    (:func:`ordered`)."""

    def call(*args, **kwargs):
        with ordered():
            return fn(*args, **kwargs)

    return call
