"""Collective operations over ``torch.distributed`` (surface of
``horovod_tpu/ops/collectives.py``).

Tensors are this rank's own: a collective takes one tensor per rank and
returns a new tensor. Grouped calls fuse their tensors into one flat wire
buffer per wire dtype, with the bucketing rule of the JAX package
(:func:`_fusion_buckets`), and issue one ``torch.distributed`` collective per
buffer (NCCL on the card, gloo on the host). Every collective takes
``process_set=`` and runs over that set's group (``process_sets.py``); a
rank outside the set raises before it enters any collective, AVERAGE
divides by the set's size, and a root rank is a global rank of the set.
``allgather`` exchanges every member's shape first (first dims may differ;
other dims that disagree raise on every member instead of hanging one), and
uneven ``alltoall`` exchanges the splits first, so that each member learns
what it receives. The object collectives pickle through
``torch.distributed``'s own.

Each eager collective's issue is a range on the timeline (``timeline.py``:
``ALLREDUCE``, ``GROUPED_ALLREDUCE``, ``ALLGATHER``, ``BROADCAST``,
``GROUPED_BROADCAST``, ``ALLTOALL``, ``REDUCESCATTER``), on the lane of
its name. Under a launcher's KV store the eager collectives negotiate
before they issue (:func:`_gate`, ``engine_service.py``): the plan gives
the agreed order, the row counts of an allgather and the received splits of an
uneven alltoall, and :func:`join` lets a rank whose data ran out send
zeros in its place (:func:`_execute_joined_zeros`). ADASUM reduces by
``ops/adasum.py`` and is not negotiated, as in the reference.

The ``*_async`` calls queue into the fusion cycle (``ops/fusion_cycle.py``:
the queued collectives fuse across calls and issue on the pipelined
executor at a flush, and ``Handle.poll``/``synchronize`` are its
triggers); ``HVD_CYCLE_TIME=0`` issues them at once. The synchronous calls
issue at once through the dispatch plan cache (``ops/dispatch_cache.py``),
after every batch submitted to the executor before them
(``ops/program_issue.ordered``); ``barrier`` and ``join`` drain the cycle
first.

Dtypes follow the reference: a scale factor on an integer tensor promotes
it to float32 (``x * pre``), a bool SUM or PRODUCT counts in int32, MIN and
MAX of bools stay bool, and ``reducescatter`` of bools raises ``TypeError``.
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch
import torch.distributed as dist

from .. import autotune, runtime, timeline
from . import adasum, dispatch_cache, fusion_cycle, program_issue
from ..process_sets import ProcessSet, _resolve
from ..utils import envs
from .compression import NoneCompressor
from .reduce_ops import ReduceOp, handle_average
from ..dynamic import (REQ_ALLGATHER, REQ_ALLREDUCE, REQ_ALLTOALL,
                       REQ_BARRIER, REQ_BROADCAST, REQ_REDUCESCATTER,
                       HorovodCollectiveError)

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def _check_op_dtype(op: ReduceOp, dtype: torch.dtype) -> None:
    if op == ReduceOp.AVERAGE and not (dtype.is_floating_point
                                       or dtype.is_complex
                                       or dtype == torch.bool):
        raise TypeError(
            "ReduceOp.AVERAGE is not supported for integer tensors "
            "(matches the reference's restriction); use SUM.")


def _wire_dtype_of(t: torch.Tensor, compression) -> torch.dtype:
    """The dtype a tensor travels the wire in: the compressor's wire dtype
    for floating tensors, int32 for bools (the reference's psum counts
    them), else the tensor's own."""
    wire = getattr(compression, "wire_dtype", None)
    if wire is not None and t.is_floating_point():
        return wire
    if t.dtype == torch.bool:
        return torch.int32
    return t.dtype


def _reduced_dtype(dtype: torch.dtype, op: ReduceOp,
                   post: float) -> torch.dtype:
    """The dtype the reference returns for an allreduce of ``dtype``: a
    bool SUM or PRODUCT is an int32 count, MIN and MAX keep bools, and a
    postscale promotes as ``x * post`` does (an integer to float32)."""
    if dtype == torch.bool and op not in (ReduceOp.MIN, ReduceOp.MAX):
        dtype = torch.int32
    if post != 1.0:
        dtype = torch.result_type(torch.empty((), dtype=dtype), post)
    return dtype


def _is_custom_compressor(compression) -> bool:
    """A compressor with its own compress/decompress pair and no cast-style
    ``wire_dtype`` (reference ``_is_custom_compressor``): only it knows the
    wire format, so it wraps the call instead of riding the fusion."""
    return (compression is not None
            and getattr(compression, "wire_dtype", None) is None
            and hasattr(compression, "compress")
            and compression is not NoneCompressor)


def _fusion_buckets(tensors, threshold: int, elem_count, dtype_of=None):
    """THE fusion bucketing rule: group indices by (wire) dtype, then split
    each group into buckets whose total bytes stay <= ``threshold``; a
    single oversized tensor gets its own bucket. ``elem_count(t)`` gives a
    tensor's element count, ``dtype_of(i)`` the wire dtype of tensor ``i``
    (default: its own dtype). Yields ``(dtype, [indices])``."""
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        dt = dtype_of(i) if dtype_of is not None else t.dtype
        by_dtype.setdefault(dt, []).append(i)
    for dt, idxs in by_dtype.items():
        bucket: list = []
        bucket_bytes = 0
        for i in idxs:
            nbytes = elem_count(tensors[i]) * dt.itemsize
            if bucket and bucket_bytes + nbytes > threshold:
                yield dt, bucket
                bucket, bucket_bytes = [], 0
            bucket.append(i)
            bucket_bytes += nbytes
        if bucket:
            yield dt, bucket


def _fuse_by_dtype(tensors: Sequence[torch.Tensor], wire_dtypes=None,
                   out_dtypes=None):
    """Pack tensors into their wire buffers (:func:`_fusion_layout`).
    Returns ``(buffers, metas)``."""
    return _pack(tensors, _fusion_layout(tensors, wire_dtypes, out_dtypes))


def _fusion_layout(tensors, wire_dtypes=None, out_dtypes=None) -> list:
    """The wire buffers of ``tensors``, one per bucket of
    :func:`_fusion_buckets` (capped at ``HVD_FUSION_THRESHOLD``), each
    tensor cast to its wire dtype (``wire_dtypes``, default its own):
    ``(wire dtype, meta)`` each, a meta holding the dtype each tensor
    comes back in (``out_dtypes``, default its own). A pure function of
    the shapes and dtypes (what a dispatch plan keeps)."""
    wire_of = (lambda i: wire_dtypes[i]) if wire_dtypes is not None else None
    outs = out_dtypes or [t.dtype for t in tensors]
    return [(dt, (idxs, [tensors[i].shape for i in idxs],
                  [outs[i] for i in idxs]))
            for dt, idxs in _fusion_buckets(
                tensors, envs.fusion_threshold_bytes(), lambda t: t.numel(),
                dtype_of=wire_of)]


def _pack(tensors, layout):
    """The wire buffers of ``layout`` (:func:`_fusion_layout`) over
    ``tensors``, and their metas."""
    with timeline.pipeline_stage("PACK"):
        bufs = [torch.cat([tensors[i].reshape(-1).to(dt) for i in meta[0]])
                for dt, meta in layout]
    return bufs, [meta for _, meta in layout]


def _split_fused(bufs, metas, count: int) -> list:
    """Inverse of :func:`_pack`: split each flat buffer back into
    its tensors, cast to each tensor's result dtype. On the card a buffer
    made on another stream (the flush executor's) is marked as used by
    the current one, which reads it from now on."""
    results: list = [None] * count
    for buf, (idxs, shapes, srcs) in zip(bufs, metas):
        if buf.is_cuda and not torch.cuda.is_current_stream_capturing():
            buf.record_stream(torch.cuda.current_stream(buf.device))
        pieces = buf.split([s.numel() for s in shapes])
        for i, piece, shape, src in zip(idxs, pieces, shapes, srcs):
            results[i] = piece.view(shape).to(src)
    return results


class Handle:
    """Completion handle of an ``*_async`` collective. ``synchronize()``
    waits for the collective (on the card: orders the current stream after
    it), applies the postscale, unpacks, and caches the result;
    :meth:`wait` does the wait alone."""

    def __init__(self, works=(), finish=None, result=None):
        self._works = list(works)
        self._finish = finish
        self._result = result
        self._done = finish is None
        self._waited = False
        self._lock = threading.Lock()

    def _wait_locked(self) -> None:
        if not self._waited:
            for w in self._works:
                w.wait()
            self._waited = True

    def wait(self) -> None:
        """Wait for the collective as :meth:`synchronize` does, leaving
        the unpack to it."""
        if not self._done:
            with self._lock:
                if not self._done:
                    self._wait_locked()

    def synchronize(self):
        if not self._done:
            with self._lock:  # the entries of one flush share a handle
                if not self._done:
                    self._wait_locked()
                    self._result = self._finish()
                    self._done = True
                    self._works, self._finish = [], None
        return self._result

    def pending_works(self) -> list:
        """The collective works not yet waited for (the flush executor's
        completion markers)."""
        return [] if self._done else list(self._works)

    def flush(self) -> None:
        """Issue the collective now if it is still queued in the fusion
        cycle (the ``bucket`` trigger; non-blocking)."""

    def poll(self) -> bool:
        """Whether the collective has finished, without waiting (on the
        card: whether its NCCL work has run)."""
        return self._done or all(w.is_completed() for w in self._works)

    def issue(self) -> None:
        """Make sure the collective has been issued; a negotiated one
        waits here for its plan (:class:`_Negotiated`)."""

    def then(self, fn) -> "Handle":
        """A handle over the same collective whose result is
        ``fn(this handle's result)``; use it in place of this one."""
        if self._done:
            return Handle(result=fn(self._result))
        return _Then(self, fn)


class _Then(Handle):
    """``parent``'s collective, its result mapped by ``fn``."""

    def __init__(self, parent: Handle, fn):
        super().__init__(finish=lambda: fn(parent.synchronize()))
        self._parent = parent

    def poll(self) -> bool:
        return self._done or self._parent.poll()

    def wait(self) -> None:
        self._parent.wait()

    def issue(self) -> None:
        self._parent.issue()

    def flush(self) -> None:
        self._parent.flush()


class _QueuedHandle(Handle):
    """A handle over a fusion-cycle entry (``ops/fusion_cycle.py``): the
    collective has not been issued yet; ``poll``/``synchronize`` flush
    the entry's queue, and :meth:`flush` issues it (``bucket``)."""

    def __init__(self, entry):
        super().__init__(finish=self._land)
        self._entry = entry

    def _land(self):
        results = fusion_cycle.scheduler().wait_result(self._entry)
        return list(results) if self._entry.grouped else results[0]

    def wait(self) -> None:
        if not self._done:
            fusion_cycle.scheduler().wait_issued_entry(self._entry)
            self._entry.results.wait()

    def poll(self) -> bool:
        return self._done or fusion_cycle.scheduler().poll_entry(self._entry)

    def flush(self) -> None:
        fusion_cycle.scheduler().flush_entry(self._entry, "bucket")

    def issue(self) -> None:
        self.flush()


class _MultiHandle(Handle):
    """One handle over per-tensor queued handles (a grouped broadcast):
    its result is their results' list."""

    def __init__(self, handles):
        super().__init__(finish=lambda: [h.synchronize() for h in handles])
        self._handles = handles

    def poll(self) -> bool:
        return self._done or all(h.poll() for h in self._handles)

    def flush(self) -> None:
        for h in self._handles:
            h.flush()


class _Negotiated(Handle):
    """A collective queued behind its negotiation (``engine_service``):
    ``synchronize()`` issues it in the agreed order, with every collective
    whose plan came before it, and waits for it."""

    def __init__(self, svc, item):
        super().__init__(finish=self._land)
        self._svc, self._item = svc, item

    def _land(self):
        self.issue()
        return self._item.result.synchronize()

    def wait(self) -> None:
        if not self._done:
            self.issue()
            self._item.result.wait()

    def issue(self) -> None:
        """Issue the collective, waiting for its plan, with every queued
        one whose plan came before it: a deterministic point of the
        program, the same on every rank."""
        self._svc.run_until(self._item)

    def poll(self) -> bool:
        """Whether the collective has finished; issues the collectives
        whose plans have arrived, without waiting (where a plan arrives
        between two polls differs between ranks, so a program that polls
        issues no other collective on the same ranks meanwhile)."""
        if self._done:
            return True
        try:
            self._svc.run_until(self._item, block=False)
        except Exception:
            return True  # finished in error: synchronize() raises it
        return self._item.issued and self._item.result.poll()


def poll(handle: Handle) -> bool:
    """Whether ``handle``'s collective has finished (reference ``poll``)."""
    return handle.poll()


def synchronize(handle: Handle):
    """Wait for ``handle``'s collective and return its result (reference
    ``synchronize``)."""
    return handle.synchronize()


# ---------------------------------------------------------------------------
# the negotiation gate (engine_service.py): under a launcher's KV store every
# eager collective below negotiates before it issues
# ---------------------------------------------------------------------------

# dtype ids of the negotiated metadata, the JAX package's table: only
# equality matters, and the table is the same on every rank
_DTYPE_NAMES = ("bool", "int8", "uint8", "int16", "uint16", "int32",
                "uint32", "int64", "uint64", "float16", "bfloat16",
                "float32", "float64", "complex64", "complex128")
_DTYPE_IDS = {name: i for i, name in enumerate(_DTYPE_NAMES)}


def _dtype_id(dt: torch.dtype) -> int:
    name = str(dt).removeprefix("torch.")
    known = _DTYPE_IDS.get(name)
    if known is not None:
        return known
    # an unlisted dtype (fp8 variants) gets an id from its name: crc32 is
    # the same in every process, unlike hash()
    import zlib
    return 0x4000_0000 | (zlib.crc32(name.encode()) & 0x3FFF_FFFF)


def _dtype_of_id(i: int) -> torch.dtype:
    if not 0 <= i < len(_DTYPE_NAMES):
        raise RuntimeError(f"hvd.join(): cannot rebuild dtype id {i}")
    return getattr(torch, _DTYPE_NAMES[i])


_auto_counters: dict = {}  # (kind, set key) -> next index


def _auto_name(kind: str, pset: ProcessSet) -> str:
    """The next name of a ``kind`` op over ``pset``: counted per (kind,
    set), so that ranks outside a set, which never see its ops, do not
    fall behind on the global ones' names."""
    from .. import engine_service
    key = (kind, engine_service._set_key(pset))
    n = _auto_counters.get(key, 0)
    _auto_counters[key] = n + 1
    return f"{kind}.{n}" if key[1] == "0" else f"{kind}.ps{key[1]}.{n}"


def _follow_auto_name(name: str) -> None:
    """A joined rank runs zeros for its peers' ops without naming them:
    its counter of ``name``'s kind moves past ``name`` as theirs did."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[1].isdigit():
        key = (parts[0], "0")
        _auto_counters[key] = max(_auto_counters.get(key, 0),
                                  int(parts[1]) + 1)


def _request(name: str, request_type: int, shape, dtype: torch.dtype,
             **meta) -> dict:
    """One negotiation request in the engine's wire format."""
    return dict(name=name, request_type=request_type,
                dtype=_dtype_id(dtype), element_size=dtype.itemsize,
                shape=tuple(int(d) for d in shape), **meta)


def _group_requests(base: str, request_type: int, shapes_dtypes,
                    **meta) -> list[dict]:
    """A grouped op's requests, named ``{base}.{i}``, with a group id from
    the base (the same on every rank): the engine schedules the group as
    one, and a joined rank finds the group's members by it."""
    import zlib
    gid = zlib.crc32(base.encode()) & 0x7FFFFFFF
    return [_request(f"{base}.{i}", request_type, shape, dtype,
                     group_id=gid, **meta)
            for i, (shape, dtype) in enumerate(shapes_dtypes)]


def _ranged(issue, lane: str, activity: str | None):
    """``issue`` inside a timeline range of ``activity`` on ``lane`` (the
    reference's per-op ranges, collectives.py:1538-2249; None: no range),
    issued in order with the flush executor's batches
    (``program_issue.ordered``)."""

    def ranged(responses=None):
        with program_issue.ordered():
            if activity is None:
                return issue(responses)
            with timeline.op_range(lane, activity):
                return issue(responses)

    return ranged


def _gate(pset: ProcessSet, kind: str, name, requests, issue,
          activity: str | None = None) -> Handle:
    """``issue(responses)``, a Handle: at once where no negotiation
    service runs for ``pset`` (``issue(None)``), else queued behind the
    negotiation of ``requests(base name)``. The issue runs inside a
    timeline range of ``activity`` on the lane of the op's name (the
    negotiated one, else the activity's in lower case)."""
    from .. import engine_service
    svc = engine_service.get_service(pset)
    if svc is None:
        return _ranged(issue, name or (activity or kind).lower(),
                       activity)(None)
    base = name or _auto_name(kind, pset)
    item = svc.submit(requests(base), _ranged(issue, base, activity))
    return _Negotiated(svc, item)


def grouped_allreduce_async(tensors: Sequence[torch.Tensor], *,
                            op: ReduceOp = ReduceOp.AVERAGE,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            compression=None,
                            process_set: ProcessSet | None = None,
                            name: str | None = None) -> Handle:
    """Start a fused allreduce of a tensor list over ``process_set``
    (reference ``grouped_allreduce_async``). The group queues into the
    fusion cycle as one entry (never split across flushes), where it may
    fuse further with other pending submissions of its signature; with
    the cycle off, or for Adasum or a custom compressor, it issues at
    once. AVERAGE lowers to SUM with a postscale of ``1/size`` of the
    set. The scale factors multiply out of place, so an integer tensor
    comes back float32 as in the reference. ``compression`` sends
    floating tensors in its wire dtype, and results come back in each
    tensor's own dtype; a compressor with its own
    ``compress``/``decompress`` and no wire dtype wraps each tensor and
    reduces what it makes, without wire-dtype fusion. With
    ``HVD_HIERARCHICAL_ALLREDUCE`` set, a SUM or AVERAGE over the global
    set reduces two-level (``ops/hierarchical.py``). ``op=Adasum``
    combines each tensor by Adasum (``ops/adasum.py``) and, as in the
    reference, ignores the scales and the compressor and is not
    negotiated. Under a negotiation service (``engine_service.py``) the
    call negotiates ``name`` (default: the next ``q_grouped_allreduce.<n>``
    when queued, ``allreduce.<n>`` when not) before it issues."""
    tensors = list(tensors)
    if not tensors:
        return Handle(result=[])
    h = fusion_cycle.queue_allreduce(
        tensors, grouped=True, op=op, process_set=process_set,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        name=name, compression=compression)
    if h is not None:
        return h
    return _grouped_allreduce_now(
        tensors, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, compression=compression,
        process_set=process_set, name=name)


def _grouped_allreduce_now(tensors, *, op, prescale_factor, postscale_factor,
                           compression, process_set, name,
                           kind: str = "grouped_allreduce") -> Handle:
    """Issue a (grouped) allreduce at once: through a dispatch plan where
    every input is a tensor and the set is plain, else through
    :func:`_reduce_async`."""
    pset = _resolve(process_set)
    tensors = list(tensors)
    if (op != ReduceOp.ADASUM and not _is_custom_compressor(compression)
            and dispatch_cache.enabled()):
        plan = _reduce_plan(tensors, pset, op, prescale_factor,
                            postscale_factor, compression, name, kind)
        if plan is not None:
            return plan.run(tensors)
    return _reduce_async(tensors, op=op, prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor,
                         compression=compression, size=pset.size(),
                         reduce=_reducer(pset, op), negotiate=pset,
                         name=name)


def _reducer(pset: ProcessSet, op: ReduceOp):
    """The reducer of a wire buffer over ``pset`` for
    :func:`_reduce_async`: two-level where ``HVD_HIERARCHICAL_ALLREDUCE``
    routes ``op`` over the set, else one flat ``all_reduce``; for ADASUM
    the ``adasum.Route`` over the set."""
    from . import hierarchical
    if op == ReduceOp.ADASUM:
        return adasum.route_for(pset)
    if (op in (ReduceOp.SUM, ReduceOp.AVERAGE)
            and hierarchical.enabled(envs.HIERARCHICAL_ALLREDUCE, pset)):
        return hierarchical.two_level_reducer(*hierarchical.level_groups())
    group = pset.group()

    def reduce(buf, dist_op):
        return dist.all_reduce(buf, op=dist_op, group=group,
                               async_op=True), buf

    return reduce


def _pipeline_key():
    """The chunking knobs a plan bakes in, or None with chunking off."""
    if not envs.pipeline_chunking_enabled():
        return None
    return (envs.pipeline_threshold_bytes(), envs.pipeline_chunks())


def _chunk_layout(layout) -> list | None:
    """The chunks of the wire buffers of ``layout``
    (:func:`_fusion_layout`): a buffer past ``HVD_PIPELINE_THRESHOLD``
    bytes is issued as ``HVD_PIPELINE_CHUNKS`` contiguous ranges, each its
    own collective (the JAX package's ``_chunk_layout``); None when no
    buffer chunks. A list of ``(bucket, start, end)`` elements."""
    if not envs.pipeline_chunking_enabled():
        return None
    threshold, chunks = envs.pipeline_threshold_bytes(), envs.pipeline_chunks()
    out, any_chunked = [], False
    for bi, (dt, (_idxs, shapes, _outs)) in enumerate(layout):
        total = sum(s.numel() for s in shapes)
        if total * dt.itemsize <= threshold or total < chunks:
            out.append((bi, 0, total))
            continue
        any_chunked = True
        step = -(-total // chunks)
        out.extend((bi, a, min(a + step, total))
                   for a in range(0, total, step))
    return out if any_chunked else None


class _Resolved:
    """Every decision of one allreduce signature, resolved once: the
    AVERAGE lowering, the wire and result dtypes, the bucket layout and
    its chunks (what a dispatch plan keeps)."""

    __slots__ = ("op", "lowered", "post", "pre", "wire", "layout", "chunks",
                 "nbytes", "count")

    def __init__(self, tensors, op, pre, post, compression, size):
        self.op = op
        self.pre = pre
        self.lowered, self.post = handle_average(op, size, post)
        dts = [torch.float32 if (op == ReduceOp.AVERAGE
                                 and t.dtype == torch.bool) else t.dtype
               for t in tensors]
        if pre != 1.0:
            dts = [torch.result_type(torch.empty((), dtype=d), pre)
                   for d in dts]
        metas = [torch.empty(0, dtype=d) for d in dts]
        self.wire = [_wire_dtype_of(m, compression) for m in metas]
        outs = [_reduced_dtype(d, self.lowered, self.post) for d in dts]
        self.layout = _fusion_layout(tensors, self.wire, outs)
        self.chunks = _chunk_layout(self.layout)
        self.nbytes = sum(t.numel() * w.itemsize
                          for t, w in zip(tensors, self.wire))
        self.count = len(tensors)


def _issue_reduce(tensors, r: _Resolved, reduce) -> Handle:
    """Pack ``tensors`` by ``r``'s layout and issue ``reduce(buffer,
    dist_op) -> (work or None, result)`` per wire buffer, or per chunk of
    a chunked buffer; the unpack (postscale, split, cast back) runs at
    ``synchronize()``."""
    if r.op == ReduceOp.AVERAGE:  # the mean of bools is a float32 share
        tensors = [t.float() if t.dtype == torch.bool else t
                   for t in tensors]
    if r.pre != 1.0:
        tensors = [t * r.pre for t in tensors]
    bufs, metas = _pack(tensors, r.layout)
    dist_op = _DIST_OPS[r.lowered]
    if r.chunks is None:
        reduced = [reduce(buf, dist_op) for buf in bufs]
        works = [w for w, _ in reduced if w is not None]
        results = [res for _, res in reduced]
        joined = lambda: results  # noqa: E731
    else:
        pieces = [[] for _ in bufs]  # (chunk, (work, result)) a buffer
        for bi, a, b in r.chunks:
            with timeline.pipeline_stage("DISPATCH"):
                chunk = bufs[bi][a:b]
                pieces[bi].append((chunk, reduce(chunk, dist_op)))
        works = [w for ps in pieces for _, (w, _) in ps if w is not None]

        def joined():
            # the flat reducer reduces each chunk in place; another one
            # hands back new pieces, joined here
            return [buf if all(res.data_ptr() == c.data_ptr()
                               for c, (_, res) in ps)
                    else torch.cat([res for _, (_, res) in ps])
                    for buf, ps in zip(bufs, pieces)]

    def finish():
        scaled = joined()
        if r.post != 1.0:  # out of place: an integer buffer turns float32
            scaled = [b.mul_(r.post) if b.is_floating_point()
                      else b * r.post for b in scaled]
        return _split_fused(scaled, metas, r.count)

    return Handle(works, finish)


def _reduce_plan(tensors, pset, op, pre, post, compression, name,
                 kind: str):
    """The dispatch plan of an allreduce of ``tensors``: looked up by the
    JAX package's key, built at a miss. None where an input is not a
    tensor."""
    from . import hierarchical
    sigs = tuple(fusion_cycle.plan_sig(t) for t in tensors)
    if any(s is None for s in sigs):
        return None
    wire = getattr(compression, "wire_dtype", None)
    comp_key = str(wire).removeprefix("torch.") if wire is not None else None
    hier = (op in (ReduceOp.SUM, ReduceOp.AVERAGE)
            and hierarchical.enabled(envs.HIERARCHICAL_ALLREDUCE, pset))
    if kind == "allreduce":  # the port's also takes a compressor
        key = ("allreduce", name, sigs[0], None,
               fusion_cycle.dispatch_key(pset), int(op), float(pre),
               float(post), hier, comp_key)
    else:
        key = ("grouped_allreduce", name, sigs, None,
               fusion_cycle.dispatch_key(pset), int(op), float(pre),
               float(post), hier, envs.fusion_threshold_bytes(), comp_key,
               _pipeline_key())
    plan = dispatch_cache.lookup(key)
    if plan is None:
        plan = _build_reduce_plan(tensors, pset, op, pre, post, compression,
                                  name, key)
        dispatch_cache.store(key, plan)
    return plan


def _build_reduce_plan(tensors, pset, op, pre, post, compression, name,
                       key):
    """Resolve an allreduce signature once: the negotiation decision (a
    service, or none pinned) and :class:`_Resolved`, which a re-formed
    world of the same shape takes from its warm pool."""
    from .. import engine_service
    for t in tensors:
        _check_op_dtype(op, t.dtype)
    svc = engine_service.get_service(pset)
    r = None
    if dispatch_cache.enabled():
        r = dispatch_cache.take_warm_stage(key)
    if r is None:
        r = _Resolved(tensors, op, float(pre), float(post), compression,
                      pset.size())
    activity = "ALLREDUCE" if len(tensors) == 1 else "GROUPED_ALLREDUCE"

    def execute(ts):
        # the reducer is a closure over the set's groups, made per call
        # (the routing knob is part of the key)
        reduce = _reducer(pset, op)

        def issue(_responses=None):
            return _issue_reduce(ts, r, reduce)

        if svc is None:
            return _ranged(issue, name or activity.lower(), activity)()
        return _gate(pset, "allreduce", name, lambda base: _group_requests(
            base, REQ_ALLREDUCE, [(t.shape, w) for t, w in zip(ts, r.wire)],
            reduce_op=int(op), prescale=float(pre),
            postscale=float(post)), issue, activity)

    return dispatch_cache.DispatchPlan(
        name or activity.lower(), activity, r.nbytes,
        None if svc is None else svc, execute,
        variant="fused" if r.chunks is None else "chunked",
        pieces=1 if r.chunks is None else len(r.chunks), stage=r)


def _reduce_async(tensors, *, op: ReduceOp, prescale_factor: float,
                  postscale_factor: float, compression, size: int,
                  reduce, negotiate: ProcessSet | None = None,
                  name: str | None = None) -> Handle:
    """The body of an allreduce over ``size`` ranks without a plan:
    checks, the custom compressor's wrap, AVERAGE's lowering, the scales,
    the fusion, then ``reduce(buffer, dist_op) -> (work or None,
    result)`` for each wire buffer, and the unpack at ``synchronize()``.
    For ADASUM ``reduce`` is an ``adasum.Route``. With ``negotiate`` (a
    process set) the wire buffers are issued behind the set's
    negotiation of ``name``: each tensor's request carries its wire dtype
    and shape, and the op and scales as given, which is what a joined rank
    needs to send zeros in their place (:func:`_execute_joined_zeros`)."""
    tensors = list(tensors)
    if not tensors:
        return Handle(result=[])
    for t in tensors:
        _check_op_dtype(op, t.dtype)
    if op == ReduceOp.ADASUM:
        # the reference's Adasum returns before the compressor and the
        # scales: an eager Adasum ignores both
        results: list = [None] * len(tensors)
        with program_issue.ordered():
            for _, idxs in _fusion_buckets(
                    tensors, envs.fusion_threshold_bytes(),
                    lambda t: t.numel(), dtype_of=lambda i: torch.float32):
                outs = adasum.reduce_tensors([tensors[i] for i in idxs],
                                             reduce)
                for i, o in zip(idxs, outs):
                    results[i] = o
        return Handle(result=results)
    if _is_custom_compressor(compression):
        pairs = [compression.compress(t) for t in tensors]
        handle = _reduce_async(
            [c for c, _ in pairs], op=op, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, compression=None, size=size,
            reduce=reduce, negotiate=negotiate, name=name)
        return handle.then(lambda outs: [
            compression.decompress(o, ctx)
            for o, (_, ctx) in zip(outs, pairs)])
    r = _Resolved(tensors, op, float(prescale_factor),
                  float(postscale_factor), compression, size)
    autotune.record(r.nbytes)

    def issue(_responses=None) -> Handle:
        return _issue_reduce(tensors, r, reduce)

    activity = "ALLREDUCE" if len(tensors) == 1 else "GROUPED_ALLREDUCE"
    if negotiate is None:
        return _ranged(issue, name or activity.lower(), activity)()
    return _gate(negotiate, "allreduce", name, lambda base: _group_requests(
        base, REQ_ALLREDUCE, [(t.shape, w) for t, w in zip(tensors, r.wire)],
        reduce_op=int(op), prescale=float(prescale_factor),
        postscale=float(postscale_factor)), issue, activity)


def _queued_grouped_allreduce(tensors, spec) -> Handle:
    """A fusion-cycle flush of an allreduce queue: one grouped collective
    through the dispatch plan cache (source ``flush``), or a plain issue
    with caching off."""
    if dispatch_cache.enabled():
        plan = _reduce_plan(tensors, spec.pset, spec.op, spec.pre,
                            spec.post, spec.compression, None,
                            "grouped_allreduce")
        if plan is not None:
            return plan.run(tensors)
    return _reduce_async(tensors, op=spec.op, prescale_factor=spec.pre,
                         postscale_factor=spec.post,
                         compression=spec.compression,
                         size=spec.pset.size(),
                         reduce=_reducer(spec.pset, spec.op))


def _run_queued_allreduce(tensors, spec, label: str) -> Handle:
    """One negotiated queue entry (a tensor, or an atomic group) in its
    submission-time composition, which is what a joined rank rebuilds from
    the plan (:func:`_execute_joined_zeros`); its plan has arrived."""
    return _reduce_async(tensors, op=spec.op, prescale_factor=spec.pre,
                         postscale_factor=spec.post,
                         compression=spec.compression,
                         size=spec.pset.size(),
                         reduce=_reducer(spec.pset, spec.op), name=label)


def grouped_allreduce(tensors: Sequence[torch.Tensor], **kw) -> list:
    """Fused allreduce of a tensor list, issued at once; see
    :func:`grouped_allreduce_async`."""
    tensors = list(tensors)
    if not tensors:
        return []
    return _grouped_allreduce_now(
        tensors, op=kw.pop("op", ReduceOp.AVERAGE),
        prescale_factor=kw.pop("prescale_factor", 1.0),
        postscale_factor=kw.pop("postscale_factor", 1.0),
        compression=kw.pop("compression", None),
        process_set=kw.pop("process_set", None), name=kw.pop("name", None),
        **kw).synchronize()


def allreduce_async(tensor: torch.Tensor, *, compression=None,
                    **kw) -> Handle:
    """Start an allreduce of one tensor (reference ``allreduce_async``):
    it queues into the fusion cycle; keywords as for
    :func:`grouped_allreduce_async`."""
    op = kw.get("op", ReduceOp.AVERAGE)
    h = fusion_cycle.queue_allreduce(
        [tensor], grouped=False, op=op,
        process_set=kw.get("process_set"),
        prescale_factor=kw.get("prescale_factor", 1.0),
        postscale_factor=kw.get("postscale_factor", 1.0),
        name=kw.get("name"), compression=compression)
    if h is not None:
        return h
    return _grouped_allreduce_now(
        [tensor], op=op, prescale_factor=kw.get("prescale_factor", 1.0),
        postscale_factor=kw.get("postscale_factor", 1.0),
        compression=compression, process_set=kw.get("process_set"),
        name=kw.get("name"), kind="allreduce").then(lambda r: r[0])


def allreduce(tensor: torch.Tensor, **kw) -> torch.Tensor:
    """Allreduce one tensor (reference ``hvd.allreduce``), issued at once;
    keywords as for :func:`grouped_allreduce_async`."""
    return _grouped_allreduce_now(
        [tensor], op=kw.pop("op", ReduceOp.AVERAGE),
        prescale_factor=kw.pop("prescale_factor", 1.0),
        postscale_factor=kw.pop("postscale_factor", 1.0),
        compression=kw.pop("compression", None),
        process_set=kw.pop("process_set", None), name=kw.pop("name", None),
        kind="allreduce", **kw).synchronize()[0]


def allreduce_(tensor: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`allreduce` written into ``tensor`` (the reference's in-place
    ``allreduce_``); returns ``tensor``."""
    out = allreduce(tensor, **kw)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def _check_root(root_rank: int, pset: ProcessSet) -> None:
    """``root_rank`` is a global rank, and must be in the set (reference
    ``broadcast``)."""
    if root_rank not in pset.ranks:
        raise ValueError(
            f"root_rank {root_rank} not in process set {pset.ranks}")


def grouped_broadcast_async(tensors: Sequence[torch.Tensor], root_rank: int,
                            *, process_set: ProcessSet | None = None,
                            name: str | None = None) -> Handle:
    """Start a broadcast of a tensor list from the global rank
    ``root_rank`` over ``process_set``; the handle's result is the new
    tensors. Each tensor queues into the fusion cycle as an entry of its
    own (so broadcasts of one root submitted apart coalesce too); with the
    cycle off it issues at once, fused into one wire buffer per dtype.
    Negotiated under a service, as an allreduce is."""
    tensors = list(tensors)
    if not tensors:
        return Handle(result=[])
    handles = []
    for i, t in enumerate(tensors):
        h = fusion_cycle.queue_broadcast(
            t, root_rank, process_set=process_set,
            name=None if name is None else f"{name}.{i}")
        if h is None:
            break
        handles.append(h)
    if len(handles) == len(tensors):
        return _MultiHandle(handles)
    prefix = [h.synchronize() for h in handles]
    rest = _grouped_broadcast_now(
        tensors[len(handles):], root_rank, process_set=process_set,
        name=None if name is None else f"{name}.rest")
    return rest.then(lambda r: prefix + r)


def _broadcast_issue(tensors, root_rank: int, group, layout):
    """Pack ``tensors`` by ``layout``, issue one broadcast a buffer, and
    split at ``synchronize()``."""

    def issue(_responses=None) -> Handle:
        bufs, metas = _pack(tensors, layout)
        works = [dist.broadcast(buf, src=root_rank, group=group,
                                async_op=True) for buf in bufs]
        return Handle(works, lambda: _split_fused(bufs, metas, len(tensors)))

    return issue


def _grouped_broadcast_now(tensors, root_rank: int, *,
                           process_set: ProcessSet | None = None,
                           name: str | None = None) -> Handle:
    """Issue a grouped broadcast at once, through its dispatch plan (the
    layout and the negotiation decision)."""
    from .. import engine_service
    tensors = list(tensors)
    pset = _resolve(process_set)
    group = pset.group()
    if not tensors:
        return Handle(result=[])
    _check_root(root_rank, pset)
    activity = "BROADCAST" if len(tensors) == 1 else "GROUPED_BROADCAST"
    key = ("grouped_broadcast", name,
           tuple(fusion_cycle.plan_sig(t) for t in tensors), None,
           fusion_cycle.dispatch_key(pset), root_rank,
           envs.fusion_threshold_bytes())
    plan = dispatch_cache.lookup(key) if dispatch_cache.enabled() else None
    if plan is None:
        layout = _fusion_layout(tensors)
        svc = engine_service.get_service(pset)

        def execute(ts):
            issue = _broadcast_issue(ts, root_rank, group, layout)
            if svc is None:
                return _ranged(issue, name or activity.lower(), activity)()
            return _gate(pset, "broadcast", name, lambda base:
                         _group_requests(base, REQ_BROADCAST,
                                         [(t.shape, t.dtype) for t in ts],
                                         root_rank=root_rank),
                         issue, activity)

        plan = dispatch_cache.DispatchPlan(
            name or activity.lower(), activity,
            sum(t.numel() * t.element_size() for t in tensors), svc,
            execute)
        dispatch_cache.store(key, plan)
    return plan.run(tensors)


def _queued_grouped_broadcast(tensors, spec) -> Handle:
    """A fusion-cycle flush of a broadcast queue: one grouped broadcast
    through the dispatch plan cache."""
    return _grouped_broadcast_now(tensors, spec.root_rank,
                                  process_set=spec.pset)


def _run_queued_broadcast(tensors, spec) -> Handle:
    """A negotiated broadcast batch (its plans have arrived): one fused
    broadcast."""
    autotune.record(sum(t.numel() * t.element_size() for t in tensors))
    issue = _broadcast_issue(tensors, spec.root_rank, spec.pset.group(),
                             _fusion_layout(tensors))
    activity = "BROADCAST" if len(tensors) == 1 else "GROUPED_BROADCAST"
    return _ranged(issue, activity.lower(), activity)()


def grouped_broadcast(tensors: Sequence[torch.Tensor], root_rank: int,
                      **kw) -> list:
    """Broadcast a tensor list from ``root_rank``, fused into one wire
    buffer per dtype and issued at once. Returns new tensors."""
    return _grouped_broadcast_now(tensors, root_rank, **kw).synchronize()


def broadcast_async(tensor: torch.Tensor, root_rank: int, **kw) -> Handle:
    """Start a broadcast of one tensor from ``root_rank`` (reference
    ``hvd.broadcast_async``): it queues into the fusion cycle;
    ``synchronize()`` gives the new tensor."""
    h = fusion_cycle.queue_broadcast(tensor, root_rank, **kw)
    if h is not None:
        return h
    return _grouped_broadcast_now([tensor], root_rank, **kw).then(
        lambda r: r[0])


def broadcast(tensor: torch.Tensor, root_rank: int, **kw) -> torch.Tensor:
    """Broadcast one tensor from ``root_rank`` (reference
    ``hvd.broadcast``), issued at once."""
    return _grouped_broadcast_now([tensor], root_rank, **kw).synchronize()[0]


def broadcast_(tensor: torch.Tensor, root_rank: int, **kw) -> torch.Tensor:
    """:func:`broadcast` written into ``tensor`` (the reference's in-place
    ``broadcast_``); returns ``tensor``."""
    out = broadcast(tensor, root_rank, **kw)
    with torch.no_grad():
        tensor.copy_(out)
    return tensor


def _stream_done(stream):
    """A finished-on-``stream`` marker: its ``wait()`` makes the current
    stream wait for ``stream``'s work so far."""
    from . import hierarchical
    return hierarchical._StreamWork(stream)


def barrier(*, process_set: ProcessSet | None = None) -> None:
    """Block until every rank of ``process_set`` reaches the barrier; a
    joined rank counts as arrived."""
    pset = _resolve(process_set)
    group = pset.group()
    fusion_cycle.flush_all("barrier")

    def issue(_responses=None) -> Handle:
        dist.barrier(group=group)
        return Handle(result=None)

    _gate(pset, "barrier", None, lambda base: [
        _request(base, REQ_BARRIER, (), torch.int32)], issue).synchronize()


_MAX_DIMS = 8  # rank of the shapes allgather's metadata exchange carries


def _all_shapes(x: torch.Tensor, size: int, group) -> list:
    """Every member's shape of ``x``, in rank order, through one allgather
    of a fixed-length int64 row (its rank, then its dims) over the
    ``size`` ranks of ``group``."""
    if x.dim() > _MAX_DIMS:
        raise ValueError(f"allgather takes tensors of at most {_MAX_DIMS} "
                         f"dimensions, got {x.dim()}")
    row = torch.zeros(_MAX_DIMS + 1, dtype=torch.int64, device=x.device)
    row[0] = x.dim()
    row[1:1 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    rows = [torch.empty_like(row) for _ in range(size)]
    dist.all_gather(rows, row, group=group)
    return [tuple(r[1:1 + int(r[0])].tolist()) for r in rows]


def allgather_async(tensor: torch.Tensor, *,
                    process_set: ProcessSet | None = None,
                    name: str | None = None) -> Handle:
    """Start an allgather (reference ``hvd.allgather_async``); see
    :func:`allgather`. It queues into the fusion cycle and issues alone at
    a flush (its row counts are exchanged, or negotiated, per call); the
    handle's result is the concatenation. With
    ``HVD_HIERARCHICAL_ALLGATHER`` set, a gather over the global set runs
    two-level (``ops/hierarchical.py``). Under a negotiation service the
    row counts come with the plan (a joined rank's are 0), and no shape
    exchange is needed."""
    h = fusion_cycle.queue_allgather(tensor, process_set=process_set,
                                     name=name)
    if h is not None:
        return h
    return _allgather_now(tensor, _resolve(process_set), name)


def _allgather_now(tensor: torch.Tensor, pset: ProcessSet,
                   name: str | None) -> Handle:
    """Issue an allgather at once (negotiated under a service)."""
    return _gate(pset, "allgather", name, lambda base: [
        _request(base, REQ_ALLGATHER, tensor.shape, tensor.dtype)],
        lambda responses=None: _allgather_issue(tensor, pset, responses),
        "ALLGATHER")


def _allgather_issue(tensor: torch.Tensor, pset: ProcessSet,
                     responses=None) -> Handle:
    """An allgather's issue: the row counts from the plan's responses
    where there are some, else exchanged first."""
    rows = None
    if responses is not None:  # a scalar is one row of every rank's
        rows = ([1] * pset.size() if tensor.dim() == 0
                else list(responses[0].recv_splits))
    return _allgather_async(tensor, pset, rows=rows)


def _queued_allgather(tensor, spec, name) -> Handle:
    """A fusion-cycle allgather entry, issued now; its result is a list of
    one."""
    h = _allgather_now(tensor, spec.pset, name)
    h.issue()
    return h.then(lambda r: [r])


def _gather_levels(pset: ProcessSet) -> tuple:
    """The two-level allgather's groups where ``HVD_HIERARCHICAL_ALLGATHER``
    routes a gather over ``pset``, else ()."""
    from . import hierarchical
    if hierarchical.enabled(envs.HIERARCHICAL_ALLGATHER, pset):
        return hierarchical.level_groups()
    return ()


def _allgather_async(tensor: torch.Tensor, pset: ProcessSet | None,
                     *levels, rows=None) -> Handle:
    """The body of :func:`allgather_async` over ``pset`` (None: the
    world), flat, or two-level over ``levels`` (``(local, cross, local
    size, cross size)`` of ``hierarchical.level_groups``; default: as the
    knob routes ``pset``). ``rows`` is every member's row count, where
    the negotiation gave it; else the shapes are exchanged first."""
    from . import hierarchical
    group = None if pset is None else pset.group()
    size = runtime.size() if pset is None else pset.size()
    if not levels and pset is not None:
        levels = _gather_levels(pset)
    x = (tensor.reshape(1) if tensor.dim() == 0 else tensor).contiguous()
    if rows is None:
        shapes = _all_shapes(x, size, group)
        if len({s[1:] for s in shapes}) > 1:
            raise ValueError(
                "allgather tensors must agree on every dimension except the "
                f"first, got shapes {shapes}")
        rows = [s[0] for s in shapes]
    width = max(rows)
    if width == 0:
        return Handle(result=x.new_empty((0,) + x.shape[1:]))
    if x.shape[0] < width:  # pad to the widest rank's rows
        x = torch.cat([x, x.new_zeros((width - x.shape[0],) + x.shape[1:])])
    if levels:
        work, parts = hierarchical.two_level_gather(x, *levels)
    else:
        flat = [torch.empty_like(x) for _ in rows]
        work = dist.all_gather(flat, x, group=group, async_op=True)
        parts = lambda: flat  # noqa: E731
    return Handle([work], lambda: torch.cat(
        [p[:r] for p, r in zip(parts(), rows)]))


def allgather(tensor: torch.Tensor, *,
              process_set: ProcessSet | None = None,
              name: str | None = None) -> torch.Tensor:
    """Concatenate every member's tensor along dim 0, in rank order
    (reference ``hvd.allgather``). First dims may differ between ranks (the
    reference's allgatherv contract): the row counts are exchanged first,
    the rows travel padded to the largest count, and the padding is cut
    off. A 0-d tensor counts as one row."""
    return _allgather_now(tensor, _resolve(process_set),
                          name).synchronize()


def alltoall(tensor: torch.Tensor, splits=None, *,
             process_set: ProcessSet | None = None, name: str | None = None):
    """All-to-all along dim 0 (reference ``hvd.alltoall``).

    Even mode (``splits=None``): the j-th of ``size`` equal chunks goes to
    rank j, and the result concatenates the chunks received, in rank order.
    Uneven mode: ``splits`` is this rank's own row, ``splits[j]`` the rows
    it sends rank j, in order from the top of ``tensor``; the row sum may be
    less than dim 0 (trailing rows are not sent). Returns ``(output,
    recv_splits)``, ``recv_splits[j]`` (int32) the rows received from rank
    j. The JAX package's single controller takes the whole ``(size, size)``
    matrix instead; each of its rows is one rank's ``splits`` here. Under
    a negotiation service the received splits come with the plan."""
    pset = _resolve(process_set)
    group = pset.group()
    n = pset.size()
    x = tensor.contiguous()
    d0 = x.shape[0] if x.dim() else 1
    if splits is None:
        if d0 % n != 0:
            raise ValueError(f"alltoall dim0 ({d0}) must be divisible "
                             f"by process set size ({n})")

        def issue_even(_responses=None) -> Handle:
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
            return Handle(result=out)

        return _gate(pset, "alltoall", name, lambda base: [
            _request(base, REQ_ALLTOALL, x.shape, x.dtype)],
            issue_even, "ALLTOALL").synchronize()
    row = torch.as_tensor(splits)
    if row.shape != (n,):
        raise ValueError(f"splits must be one row of length {n}, got shape "
                         f"{tuple(row.shape)}")
    send = [int(s) for s in row.tolist()]
    if min(send) < 0:
        raise ValueError("splits entries must be non-negative")
    if sum(send) > d0:
        raise ValueError(
            f"sum of splits entries exceeds the first dimension ({d0}) "
            "(reference operations.cc:1703-1707)")

    def issue(responses=None) -> Handle:
        if responses is None:
            send_t = torch.tensor(send, dtype=torch.int64, device=x.device)
            recv_t = torch.empty_like(send_t)
            dist.all_to_all_single(recv_t, send_t, group=group)
            recv = recv_t.tolist()
        else:
            recv = [int(r) for r in responses[0].recv_splits]
        out = x.new_empty((sum(recv),) + x.shape[1:])
        dist.all_to_all_single(out, x[:sum(send)], output_split_sizes=recv,
                               input_split_sizes=send, group=group)
        return Handle(result=(out, torch.tensor(recv, dtype=torch.int32)))

    return _gate(pset, "alltoall", name, lambda base: [
        _request(base, REQ_ALLTOALL, x.shape, x.dtype, splits=send)],
        issue, "ALLTOALL").synchronize()


def alltoall_async(tensor: torch.Tensor, splits=None, **kw) -> Handle:
    """A handle over :func:`alltoall`, issued at the call (the reference's
    ``alltoall_async``)."""
    return Handle(result=alltoall(tensor, splits, **kw))


def reducescatter(tensor: torch.Tensor, *, op: ReduceOp = ReduceOp.SUM,
                  process_set: ProcessSet | None = None,
                  name: str | None = None) -> torch.Tensor:
    """Reduce every member's tensor and give the set's r-th member the r-th
    of ``size`` equal chunks along dim 0 (reference ``hvd.reducescatter``).
    ``op`` is SUM or AVERAGE (SUM, then a postscale of ``1/size``)."""
    pset = _resolve(process_set)
    group = pset.group()
    if tensor.dtype == torch.bool:  # the reference's jnp add refuses bools
        raise TypeError(
            "add does not accept dtype bool at position 0. Accepted dtypes "
            "at position 0 are subtypes of integer, floating, "
            "complexfloating.")
    _check_op_dtype(op, tensor.dtype)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise NotImplementedError("reducescatter supports SUM/AVERAGE")
    n = pset.size()
    x = tensor.contiguous()
    if x.dim() == 0 or x.shape[0] % n != 0:
        raise ValueError(f"reducescatter dim0 ({x.shape[0] if x.dim() else 1}"
                         f") must be divisible by process set size ({n})")
    lowered, post = handle_average(op, n, 1.0)

    def issue(_responses=None) -> Handle:
        out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x, op=_DIST_OPS[lowered],
                                   group=group)
        if post != 1.0:
            out.mul_(post)
        return Handle(result=out)

    return _gate(pset, "reducescatter", name, lambda base: [
        _request(base, REQ_REDUCESCATTER, x.shape, x.dtype,
                 reduce_op=int(op))], issue, "REDUCESCATTER").synchronize()


def broadcast_object(obj, root_rank: int = 0, *,
                     process_set: ProcessSet | None = None,
                     name: str | None = None):
    """Broadcast a picklable object from the global rank ``root_rank``
    (reference ``broadcast_object``): every member gets the root's
    object."""
    del name
    pset = _resolve(process_set)
    group = pset.group()
    _check_root(root_rank, pset)
    if pset.size() == 1:
        return obj
    box = [obj if runtime.rank() == root_rank else None]
    with program_issue.ordered():
        dist.broadcast_object_list(box, src=root_rank, group=group)
    return box[0]


def allgather_object(obj, *, process_set: ProcessSet | None = None,
                     name: str | None = None) -> list:
    """Every member's picklable object, in rank order (reference
    ``allgather_object``)."""
    del name
    pset = _resolve(process_set)
    group = pset.group()
    if pset.size() == 1:
        return [obj]
    out = [None] * pset.size()
    with program_issue.ordered():
        dist.all_gather_object(out, obj, group=group)
    return out


def _execute_joined_zeros(responses) -> None:
    """A joined rank's part in the collectives its peers scheduled
    (reference ``JoinOp``, ``collective_operations.h:275-290``): zeros of
    the negotiated dtypes and shapes to each allreduce, through the same
    fusion and reducer as the peers', zero rows to each allgather, and its
    arrival to each barrier, in the agreed order. Runs on the service's
    cycle thread while this rank's own thread is blocked in :func:`join`;
    any other collective raises (docs/join.md)."""
    pset = _resolve(None)
    dev = runtime.device()
    units: dict = {}  # key -> [position of its last name, response, parts]
    position = 0
    for resp in responses:
        for i, tname in enumerate(resp.tensor_names):
            _follow_auto_name(tname)
            if resp.type == REQ_ALLREDUCE:
                gid = resp.group_ids[i] if i < len(resp.group_ids) else -1
                unit = units.setdefault(("allreduce", gid if gid >= 0
                                         else tname), [0, resp, []])
                unit[2].append((tname, resp.shapes[i], resp.dtype))
            elif resp.type in (REQ_ALLGATHER, REQ_BARRIER):
                unit = units.setdefault((resp.type, tname), [0, resp, []])
            else:
                # every joined rank reads this from the same agreed plan:
                # an agreed error, not a local failure (no poison record)
                raise HorovodCollectiveError(
                    f"hvd.join(): another rank scheduled a "
                    f"{resp.type_name} ({resp.tensor_names}) while this one "
                    "is joined; zero contribution is defined for "
                    "allreduce, allgather and barrier only (reference "
                    "JoinOp semantics)")
            unit[0] = position
            position += 1
    for (kind, _), (_, resp, parts) in sorted(units.items(),
                                              key=lambda kv: kv[1][0]):
        if kind == REQ_BARRIER:
            dist.barrier()
        elif kind == REQ_ALLGATHER:
            # zero rows; a scalar gather takes one zero of every rank, as
            # the reference's (n, 1) program does
            shape = tuple(resp.shapes[0]) if resp.shapes else ()
            rows = ([1] * pset.size() if not shape
                    else list(resp.recv_splits))
            zeros = torch.zeros((1 - bool(shape),) + shape[1:], device=dev,
                                dtype=_dtype_of_id(resp.dtype))
            _allgather_async(zeros, pset, rows=rows).synchronize()
        else:  # one grouped allreduce, its tensors in the peers' order
            parts.sort(key=lambda p: int(p[0].rsplit(".", 1)[1]))
            op = ReduceOp(resp.reduce_op)
            _reduce_async(
                [torch.zeros(shape, dtype=_dtype_of_id(dt), device=dev)
                 for _, shape, dt in parts], op=op, prescale_factor=1.0,
                postscale_factor=1.0, compression=None, size=pset.size(),
                reduce=_reducer(pset, op)).synchronize()


def join() -> int:
    """Reference ``hvd.join`` (``operations.cc:1729-1761``): a rank whose
    data ran out drops out. Until every rank has joined, it contributes
    zeros to the allreduces the others still run (an AVERAGE still
    divides by the whole world), zero rows to their allgathers, and counts
    as arrived at their barriers; a broadcast, alltoall or reducescatter
    meanwhile raises on every rank. Returns the last rank to join, the
    same on every rank. The rank's own queued collectives are issued
    first. Without a negotiation service it is a barrier that returns
    ``size() - 1``."""
    from .. import engine_service
    pset = _resolve(None)
    svc = engine_service.get_service(pset)
    fusion_cycle.flush_all("join")
    if svc is None:
        barrier()
        return runtime.size() - 1
    svc.run_until()
    last = svc.join(_auto_name("join", pset))
    return runtime.size() - 1 if last < 0 else last
