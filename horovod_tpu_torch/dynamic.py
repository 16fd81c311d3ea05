"""The negotiation engine's Python face (port of ``horovod_tpu/dynamic.py``).

:class:`NativeEngine` owns one instance of the native engine
(``native/engine.cc``, built and bound by :mod:`horovod_tpu_torch._native`):
the reference's TensorQueue, Controller negotiation, ResponseCache,
GroupTable and StallInspector. The protocol is symmetric: every member
ingests the same rank-ordered request lists and computes the same fused
response plan. One negotiation cycle is:

1. ``pop_requests()``             -- serialize my pending requests
2. transport exchange             -- allgather everyone's request bytes
3. ``cache_bits()``               -- my cache-hit bitvector (pre-ingest)
4. transport AND                  -- bitwise AND across members
5. ``commit_cache_bits(anded)``   -- serve globally cache-hit tensors
6. ``ingest(rank, bytes)``        -- in rank order, on every member
7. ``compute_responses()``        -- fused plan for globally-ready tensors

The wire format (``native/wire.h``) and the request and response type ids
(``native/hvd_core.h``) are those of the JAX package, so the same request
sequences give the same responses under either package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import threading

from . import _native
from .utils import envs

# Request/response type ids of native/hvd_core.h (the reference's
# message.h:52-54,155-157).
REQ_ALLREDUCE = 0
REQ_ALLGATHER = 1
REQ_BROADCAST = 2
REQ_JOIN = 3
REQ_ADASUM = 4
REQ_ALLTOALL = 5
REQ_BARRIER = 6
REQ_REDUCESCATTER = 7

RESP_ERROR = 8
DEFAULT_CACHE_CAPACITY = 1024  # the reference's (global_state.h:89)

_RESP_NAMES = {
    0: "ALLREDUCE", 1: "ALLGATHER", 2: "BROADCAST", 3: "JOIN", 4: "ADASUM",
    5: "ALLTOALL", 6: "BARRIER", 7: "REDUCESCATTER", 8: "ERROR",
}


class DuplicateNameError(ValueError):
    """A tensor name was enqueued while a request with the same name is
    still in flight (reference ``common.h:229-232``)."""


class HorovodCollectiveError(RuntimeError):
    """The negotiation produced an ERROR response — ranks disagreed on
    type/dtype/shape/root for a tensor (reference ``ConstructResponse``
    mismatch errors, ``controller.cc``)."""


@dataclasses.dataclass
class Response:
    type: int
    tensor_names: list
    dtype: int = 0
    root_rank: int = -1
    total_bytes: int = 0
    from_cache: bool = False
    error_message: str = ""
    # ALLTOALL: rows this rank receives from each rank (negotiated; the
    # reference's AlltoallGetRecvSplits metadata).
    recv_splits: list = dataclasses.field(default_factory=list)
    # Per-tensor shapes + group ids (aligned with tensor_names) and reduce
    # parameters, so a JOINed rank can execute the identical program with
    # zero inputs (reference JoinOp, collective_operations.h:275-290).
    shapes: list = dataclasses.field(default_factory=list)
    group_ids: list = dataclasses.field(default_factory=list)
    reduce_op: int = -1
    prescale: float = 1.0
    postscale: float = 1.0

    @property
    def type_name(self) -> str:
        return _RESP_NAMES.get(self.type, "?")

    @property
    def is_error(self) -> bool:
        return self.type == RESP_ERROR


@dataclasses.dataclass
class StallEntry:
    tensor_name: str
    ready_ranks: list
    waiting_seconds: float

    def missing_ranks(self, world_size: int) -> list:
        return [r for r in range(world_size) if r not in set(self.ready_ranks)]


class _Reader:
    """Little-endian reader matching native/wire.h."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self):
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        return v

    def i32(self):
        (v,) = struct.unpack_from("<i", self.buf, self.pos)
        self.pos += 4
        return v

    def i64(self):
        (v,) = struct.unpack_from("<q", self.buf, self.pos)
        self.pos += 8
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v

    def str(self):
        n = self.u32()
        s = self.buf[self.pos:self.pos + n].decode()
        self.pos += n
        return s


def parse_responses(data: bytes) -> list[Response]:
    r = _Reader(data)
    out = []
    for _ in range(r.u32()):
        t = r.u8()
        dtype = r.i32()
        root = r.i32()
        total = r.i64()
        from_cache = r.u8() != 0
        err = r.str()
        names = [r.str() for _ in range(r.u32())]
        recv_splits = [r.i32() for _ in range(r.u32())]
        shapes = [tuple(r.i64() for _ in range(r.u32()))
                  for _ in range(r.u32())]
        group_ids = [r.i32() for _ in range(r.u32())]
        reduce_op = r.i32()
        prescale = r.f64()
        postscale = r.f64()
        out.append(Response(type=t, tensor_names=names, dtype=dtype,
                            root_rank=root, total_bytes=total,
                            from_cache=from_cache, error_message=err,
                            recv_splits=recv_splits, shapes=shapes,
                            group_ids=group_ids, reduce_op=reduce_op,
                            prescale=prescale, postscale=postscale))
    return out


def parse_requests(data: bytes) -> list[dict]:
    """Parse one member's serialized request list (the Python twin of
    ``native/message.h`` ``RequestList::parse``): each request's
    ``rank``, ``request_type`` and ``name``."""
    if not data:
        return []
    r = _Reader(data)
    out = []
    for _ in range(r.u32()):
        rank = r.i32()
        rtype = r.u8()
        r.i32()  # dtype
        r.i32()  # element_size
        r.i32()  # root_rank
        r.i32()  # group_id
        name = r.str()
        for _ in range(r.u32()):  # shape
            r.i64()
        for _ in range(r.u32()):  # splits
            r.i32()
        r.i32()  # reduce_op
        r.f64()  # prescale
        r.f64()  # postscale
        r.i32()  # splits_crc
        out.append({"rank": rank, "request_type": rtype, "name": name})
    return out


def parse_stall_report(data: bytes) -> list[StallEntry]:
    r = _Reader(data)
    out = []
    for _ in range(r.u32()):
        name = r.str()
        n = r.u32()
        ranks = [r.u32() for _ in range(n)]
        waited = r.f64()
        out.append(StallEntry(name, ranks, waited))
    return out


def and_bitvectors(vectors: list[bytes]) -> bytes:
    """Bitwise AND of per-rank cache-hit bitvectors (the transport's reduce
    for step 5; reference uses MPI_BAND, ``mpi_controller.cc:115-123``)."""
    if not vectors:
        return b""
    n = max(len(v) for v in vectors)
    acc = bytearray(vectors[0].ljust(n, b"\x00"))
    for v in vectors[1:]:
        padded = v.ljust(n, b"\x00")
        for i in range(n):
            acc[i] &= padded[i]
    return bytes(acc)


class NativeEngine:
    """Thin ownership wrapper over one native engine instance."""

    def __init__(self, world_size: int = 1, rank: int = 0, *,
                 fusion_threshold: int | None = None,
                 cache_capacity: int | None = None,
                 stall_warn: float | None = None,
                 stall_shutdown: float | None = None):
        self._lib = _native.load()
        if fusion_threshold is None:
            fusion_threshold = envs.fusion_threshold_bytes()
        if cache_capacity is None:
            cache_capacity = DEFAULT_CACHE_CAPACITY
        if stall_warn is None:
            stall_warn = envs.get_float(
                envs.STALL_CHECK_TIME_SECONDS,
                envs.DEFAULT_STALL_WARNING_SECONDS)
        if stall_shutdown is None:
            stall_shutdown = envs.get_float(envs.STALL_SHUTDOWN_TIME_SECONDS,
                                            0.0)
        self.world_size = world_size
        self.rank = rank
        self._h = self._lib.hvd_engine_create(
            world_size, rank, fusion_threshold, cache_capacity,
            float(stall_warn), float(stall_shutdown))
        self._mu = threading.Lock()

    def close(self):
        with self._mu:
            if self._h:
                self._lib.hvd_engine_destroy(self._h)
                self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass  # at interpreter exit the library may be gone first

    # -- worker side -------------------------------------------------------

    def enqueue(self, name: str, request_type: int, *, dtype: int = 0,
                element_size: int = 4, shape=(), root_rank: int = -1,
                group_id: int = -1, splits=(), reduce_op: int = -1,
                prescale: float = 1.0, postscale: float = 1.0,
                splits_crc: int = 0) -> None:
        shape = tuple(int(d) for d in shape)
        arr = (ctypes.c_int64 * len(shape))(*shape)
        splits = tuple(int(s) for s in splits)
        sarr = (ctypes.c_int32 * len(splits))(*splits)
        rc = self._lib.hvd_engine_enqueue(
            self._h, name.encode(), request_type, dtype, element_size,
            arr, len(shape), root_rank, group_id, sarr, len(splits),
            int(reduce_op), float(prescale), float(postscale),
            int(splits_crc))
        if rc == -3:
            raise ValueError(
                f"invalid alltoall splits for {name!r}: must be length "
                "world_size, non-negative, and sum to at most the tensor's "
                "first dimension (reference operations.cc:1691-1727)")
        if rc == -2:
            raise DuplicateNameError(
                f"tensor name {name!r} is still in flight from a timed-out "
                "negotiation with different type/dtype/shape/root metadata; "
                "a retry must match the original request (or use a new name)")
        if rc < 0:
            raise DuplicateNameError(
                f"tensor name {name!r} was enqueued while a request with "
                "the same name is still pending; pass a unique name= "
                "(reference detects the same condition, common.h:229-232)")

    def _out_call(self, fn) -> bytes:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_size_t()
        rc = fn(self._h, ctypes.byref(ptr), ctypes.byref(length))
        data = ctypes.string_at(ptr, length.value) if length.value else b""
        return rc, data

    def pop_requests(self) -> bytes:
        _, data = self._out_call(self._lib.hvd_engine_pop_requests)
        return data

    # -- negotiation -------------------------------------------------------

    def ingest(self, rank: int, data: bytes) -> None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data \
            else (ctypes.c_uint8 * 0)()
        rc = self._lib.hvd_engine_ingest(self._h, rank, buf, len(data))
        if rc != 0:
            raise ValueError(f"malformed request list from rank {rank}")

    def cache_bits(self) -> bytes:
        _, data = self._out_call(self._lib.hvd_engine_cache_bits)
        return data

    def commit_cache_bits(self, bits: bytes) -> None:
        buf = (ctypes.c_uint8 * len(bits)).from_buffer_copy(bits) if bits \
            else (ctypes.c_uint8 * 0)()
        self._lib.hvd_engine_commit_cache_bits(self._h, buf, len(bits))

    def compute_responses(self) -> list[Response]:
        _, data = self._out_call(self._lib.hvd_engine_compute_responses)
        return parse_responses(data)

    def stall_report(self) -> tuple[list[StallEntry], bool]:
        rc, data = self._out_call(self._lib.hvd_engine_stall_report)
        return parse_stall_report(data), rc == 1

    def register_group(self, group_id: int, n_members: int) -> None:
        self._lib.hvd_engine_register_group(self._h, group_id, n_members)

    def abandon(self, name: str) -> bool:
        """Drop a locally-submitted request (post-timeout retry path).
        Returns True if the name was outstanding."""
        return self._lib.hvd_engine_abandon(self._h, name.encode()) == 0

    # -- introspection -----------------------------------------------------

    def pending_count(self) -> int:
        return self._lib.hvd_engine_pending_count(self._h)

    def cache_size(self) -> int:
        return self._lib.hvd_engine_cache_size(self._h)

    def cache_has(self, name: str) -> bool:
        """Whether ``name`` is held by the native response cache."""
        return self._lib.hvd_engine_cache_has(self._h, name.encode()) == 1

    def join_pending(self) -> bool:
        """Whether any rank's JOIN is in flight (ingested, not yet
        completed by every rank joining)."""
        return self._lib.hvd_engine_join_pending(self._h) == 1

    # -- timeline ----------------------------------------------------------

    def timeline_start(self, path: str) -> None:
        """Open ``path`` and start this engine's Chrome-trace writer."""
        if self._lib.hvd_timeline_start(self._h, path.encode()) != 0:
            raise OSError(f"cannot open timeline file {path!r}")

    def timeline_stop(self) -> None:
        """Flush and close the trace (idempotent)."""
        self._lib.hvd_timeline_stop(self._h)

    def timeline_record(self, tensor: str, activity: str, phase: int,
                        timestamp_us: int = -1) -> None:
        """Queue one record (phase 0 begin, 1 end, 2 instant) for the
        writer; ``timestamp_us < 0`` stamps it with the engine's clock."""
        self._lib.hvd_timeline_record(self._h, tensor.encode(),
                                      activity.encode(), phase, timestamp_us)


def drive_cycle(engines: list[NativeEngine]) -> list[list[Response]]:
    """Run one full symmetric negotiation cycle across in-memory engines.

    Horovod's own tests run real 2-process mpirun jobs; this in-memory
    cycle of several engines runs the identical protocol without processes
    (the transport — one batched allgather of (requests, cache bits) — is
    played by plain Python). Also documents the canonical cycle order for
    real transports: bits are computed against the pre-ingest cache state
    (so bit positions agree on every member), the AND-served set commits
    first, then ingest skips served names.
    """
    datas = [e.pop_requests() for e in engines]
    anded = and_bitvectors([e.cache_bits() for e in engines])
    for e in engines:
        e.commit_cache_bits(anded)
    for e in engines:
        for rank, data in enumerate(datas):
            e.ingest(rank, data)
    return [e.compute_responses() for e in engines]
