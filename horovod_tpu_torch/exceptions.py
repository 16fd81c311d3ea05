"""Framework exceptions, with the names of ``horovod_tpu/exceptions.py`` so
that user code catches the same types under either package."""

from __future__ import annotations


class HorovodInternalError(RuntimeError):
    """A collective routine failed mid-flight (in elastic mode this triggers
    a state restore and re-initialization instead of aborting the job)."""


class PeerFailureError(HorovodInternalError):
    """A peer rank was declared dead, naming the tensors it still owed."""

    def __init__(self, rank: int, reason: str, owed_tensors=()):
        self.rank = rank
        self.reason = reason
        self.owed_tensors = tuple(owed_tensors)
        owed = (f"; undelivered tensors: {list(self.owed_tensors)}"
                if self.owed_tensors else "")
        super().__init__(f"peer rank {rank} failed: {reason}{owed}")


class ResponseCacheJoinError(HorovodInternalError):
    """The coordinator ResponseCache served a batch locally while a peer's
    JOIN was in flight (``HVD_RESPONSE_CACHE``): those collectives never
    went through a real round, so the joined rank cannot pair them. The
    service detects the race on the cycle that first sees the JOIN and
    fails at once with this error, naming the joining rank."""

    def __init__(self, joining_rank: int, served_batches: int):
        self.joining_rank = joining_rank
        self.served_batches = served_batches
        who = (f"rank {joining_rank}" if joining_rank >= 0
               else "an unidentified rank")
        super().__init__(
            f"coordinator ResponseCache served {served_batches} batch(es) "
            f"locally while {who}'s JOIN was in flight (pre-join-latch "
            "window); the served collectives cannot pair with the joined "
            "rank — re-negotiate (elastic mode re-forms automatically). "
            "Keep HVD_RESPONSE_CACHE off for join-terminated workloads "
            "(docs/negotiation.md).")


class HostsUpdatedInterrupt(RuntimeError):
    """The set of available hosts changed; ``skip_sync`` is True when hosts
    were only removed."""

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class QosAdmissionError(RuntimeError):
    """An async collective submission was shed at enqueue by its tenant's
    QoS admission control (``hvd.set_qos(..., policy="shed")`` /
    ``HVD_QOS_*``): the tenant's unacknowledged pending bytes would exceed
    its quota. Raised from the submission's handle (``synchronize()``).
    Flow control on a healthy engine, not a peer failure, so not a
    :class:`HorovodInternalError`."""

    def __init__(self, tenant: str, nbytes: int, pending: int, quota: int):
        self.tenant = tenant
        self.nbytes = int(nbytes)
        self.pending = int(pending)
        self.quota = int(quota)
        super().__init__(
            f"tenant {tenant!r}: submission of {nbytes} B shed by QoS "
            f"admission control ({pending} B already pending, quota "
            f"{quota} B)")


# Error-message fragments of a membership or communication failure
# (recoverable by re-forming the world) rather than a user bug, matched only
# on exception types the distributed runtime itself raises: torch's
# ``DistError`` family (``DistBackendError`` carries NCCL's errors) and the
# port's own modules. A user's HTTP 503 ("service unavailable") surfaces as
# its own traceback, not as an elastic retry.
_TRANSIENT_DISTRIBUTED_MARKERS = (
    "distributed",
    "heartbeat",
    "coordination service",
    "preemption",
    "deadline exceeded",
    "unavailable",
    "connection reset",
    "connection closed",
    "connection refused",
    "socket closed",
    "broken pipe",
    "barrier",
    # collective failures when a peer dies mid-operation
    "gloo",
    "nccl",
    "all-reduce failed",
    "all-gather failed",
    "collective",
    "peer",
    "timed out",
)

# For exceptions of a builtin type (the RuntimeError gloo raises when a
# peer closes its connection, a TimeoutError of a store) the type's module
# tells nothing, so only multi-word phrases specific to the collective
# runtime qualify: single words such as "unavailable" or "peer" would
# swallow ordinary user errors.
_STRICT_DISTRIBUTED_MARKERS = (
    "coordination service",
    "torch.distributed",
    "distributed runtime",
    "process group",
    "connection closed by peer",
    "connection reset by peer",
    "all-reduce failed",
    "all-gather failed",
    "all-to-all failed",
    "nccl error",
    "ncclremoteerror",
    "ncclsystemerror",
    "ncclinternalerror",
    "gloo broadcast failed",
    "gloo reduce failed",
    "gloo barrier failed",
)


def _is_runtime_module(mod: str) -> bool:
    """Whether an exception type's module is the distributed runtime's:
    ``torch.distributed`` (its ``DistError``, ``DistBackendError``,
    ``DistNetworkError`` and ``DistStoreError``), torch's C extension,
    which defines them, and the port's own modules. Not a user library
    whose name merely starts with ``torch`` (``torchvision``)."""
    return (mod in ("torch.distributed", "torch._C", "horovod_tpu_torch")
            or mod.startswith(("torch.distributed.", "torch._C.",
                               "horovod_tpu_torch.")))


def is_recoverable_distributed_error(exc: BaseException) -> bool:
    """Whether ``exc`` looks like a peer or communication failure that
    elastic mode should recover from: broad markers on exception types of
    the distributed runtime (:func:`_is_runtime_module`), multi-word
    phrases specific to it on any other type."""
    text = f"{type(exc).__name__}: {exc}".lower()
    mod = type(exc).__module__ or ""
    if _is_runtime_module(mod):
        return any(m in text for m in _TRANSIENT_DISTRIBUTED_MARKERS)
    return any(m in text for m in _STRICT_DISTRIBUTED_MARKERS)


def wrap_internal_errors(fn):
    """Decorator turning recoverable distributed-runtime errors into
    :class:`HorovodInternalError`, which ``elastic.run_fn`` catches."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (HorovodInternalError, HostsUpdatedInterrupt):
            raise
        except Exception as e:
            if is_recoverable_distributed_error(e):
                raise HorovodInternalError(str(e)) from e
            raise

    return wrapper
