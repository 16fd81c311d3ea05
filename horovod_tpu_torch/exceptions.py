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


class QosAdmissionError(RuntimeError):
    """An async submission was shed by its tenant's QoS admission control.
    Not a :class:`HorovodInternalError`: shedding is flow control."""

    def __init__(self, tenant: str, nbytes: int, pending: int, quota: int):
        self.tenant = tenant
        self.nbytes = int(nbytes)
        self.pending = int(pending)
        self.quota = int(quota)
        super().__init__(
            f"tenant {tenant!r}: submission of {nbytes} B shed by QoS "
            f"admission control ({pending} B already pending, quota "
            f"{quota} B)")


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
