"""Distributed optimizer wrapper (port of ``horovod_tpu/optim/__init__.py``).

:class:`DistributedOptimizer` wraps a ``torch.optim.Optimizer`` and reduces
the parameters' gradients over the ranks while the backward pass runs:

* The dense gradients are cut into size-bounded buckets taken in reverse
  parameter order (:func:`_bucket_layout`, ``HVD_BUCKET_BYTES``), a pure
  function of the parameter shapes, so every rank has the same buckets.
* A hook on each parameter (``register_post_accumulate_grad_hook``) marks
  its gradient as landed. Once a bucket's last gradient has landed, and
  every earlier bucket has started, the bucket's fused
  ``grouped_allreduce_async`` starts: buckets start strictly in bucket
  order, so every rank issues the same stream of collectives (NCCL pairs
  them by issue order), as the DDP reducer does.
* ``step()`` (or :meth:`DistributedOptimizer.synchronize`) starts the
  buckets that are left, with a gradient that never landed sent as zeros,
  reduces the sparse-routed gradients, waits for every bucket and writes
  the results to ``.grad``; then the wrapped optimizer steps.
* ``op=Adasum`` combines each gradient by Adasum (``ops/adasum.py``),
  one set of coefficients per gradient, its buckets started in the
  backward pass as the others; it takes no scale factors and ignores the
  compressor, as the reference's eager Adasum does.
* A bucket goes through the fusion cycle (``ops/fusion_cycle.py``): it
  is queued as one grouped entry and flushed at once (the ``bucket``
  trigger), and the pipelined executor issues it on its own thread and
  stream while the backward pass goes on. Adasum, a custom compressor,
  ``mesh_spec`` and ``HVD_CYCLE_TIME=0`` issue at once instead.
* Under a negotiation service (``engine_service.py``) each bucket
  negotiates: its flush submits the request without waiting for a KV
  round, and the executor issues the bucket in the agreed order once its
  plan has arrived. With ``hvd.join()``, a rank whose data ran out sends
  zeros in its place.
* With ``HVD_STEP_CAPTURE=1`` the buckets of a pass form a capture region
  (``ops/step_capture.auto_region``) unless a user's
  ``hvd.step_marker()`` region is open: the first pass is recorded, and
  every later pass's sync replays as one CUDA Graph once its last bucket
  arrives. The reduced gradients are written into ``.grad`` in place;
  keep them there (``zero_grad(set_to_none=False)``): a gradient at a new
  address is a divergence, which runs that pass eagerly.
* ``mesh_spec`` (a ``parallel.mesh.MeshLayout``) reduces every bucket
  two-level over the layout (the node, then ``dcn``): the reference's
  composed step, whose ``pmean`` over the ``seq`` or ``expert`` axis comes
  before its data-axis sync (``parallel.mesh.step_reducer``).
* Inside ``hvd.cached_step`` (``ops/gspmd_cache.py``) the whole step,
  this sync included, is captured into one CUDA Graph on the card; while
  it is captured the buckets are issued at once on the capturing stream.
* ``backward_passes_per_step=k`` is ``optax.MultiSteps``: the first k-1
  calls of ``step()`` fold ``.grad`` into a float32 running mean
  (``acc + (g - acc) / n``) and change nothing else; the k-th reduces the
  mean and steps. Call ``zero_grad()`` before every backward pass.

:func:`value_and_grad` and :func:`grad` are the reference's twins over
``torch.autograd.grad``: the gradients are allreduced, the value is not.
"""

from __future__ import annotations

import re
import weakref

import torch

from .. import runtime, timeline
from ..ops import collectives, fusion_cycle, gspmd_cache, step_capture
from ..ops import sparse as sparse_ops
from ..ops.compression import Compression, Compressor
from ..ops.reduce_ops import ReduceOp
from ..process_sets import ProcessSet, _resolve
from ..utils import envs


def _sparse_rows_for(name: str, sparse_gradient_paths, sparse_max_rows):
    """max_rows for a sparse-routed parameter, or None for the dense path
    (reference ``_sparse_rows_for``)."""
    if not sparse_gradient_paths:
        return None
    for pat in sparse_gradient_paths:
        if re.search(pat, name):
            if isinstance(sparse_max_rows, dict):
                for k, v in sparse_max_rows.items():
                    if re.search(k, name):
                        return int(v)
                raise ValueError(
                    f"sparse gradient leaf {name!r} matched "
                    f"{pat!r} but sparse_max_rows has no entry for it")
            return int(sparse_max_rows)
    return None


def _bucket_layout(sizes, cap: int) -> list[list[int]]:
    """Partition leaf indices into contiguous buckets of at most ``cap``
    bytes each, walking the leaves in REVERSE order (the backward pass
    produces the last layers' gradients first). A single leaf larger than
    ``cap`` forms its own bucket. A pure function of the sizes, so every
    rank issues the identical bucket stream."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i in reversed(range(len(sizes))):
        if cur and cur_bytes + sizes[i] > cap:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sizes[i]
    if cur:
        buckets.append(cur)
    return buckets


class DistributedOptimizer:
    """Wrap ``optimizer`` so that its updates see gradients reduced over
    ``process_set`` (reference ``hvd.DistributedOptimizer``). ``op``,
    ``compression`` and the scale factors apply to every gradient.

    ``sparse_gradient_paths`` (regexes searched in the names that
    ``named_parameters``, e.g. ``model.named_parameters()``, gives) sends
    each matching 2-D gradient through
    ``ops.sparse.sparse_allreduce_to_dense`` with ``sparse_max_rows`` rows
    (an int, or a dict of name regex to int). A rank outside
    ``process_set`` steps on its own gradients. ``stats`` holds the bucket
    sizes in bytes and, for each reducing step, how many buckets started
    during the backward pass (and each sparse-routed parameter's
    ``max_rows``). ``mesh_spec`` (a ``parallel.mesh.MeshLayout``, or the
    name pair of its data axes for ``default_layout()``) averages over the
    layout's ``seq``/``expert`` axes and its data axes, two-level, instead
    of over a process set (reference ``_mesh_spec_sync`` after the composed
    step's ``pmean``). Attributes other than ``step`` and
    ``synchronize`` are the wrapped optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer, *,
                 named_parameters=None,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 process_set: ProcessSet | None = None,
                 compression: type[Compressor] = Compression.none,
                 prescale_factor: float = 1.0, postscale_factor: float = 1.0,
                 backward_passes_per_step: int = 1,
                 sparse_gradient_paths=None, sparse_max_rows=None,
                 mesh_spec=None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        if op == ReduceOp.ADASUM and (prescale_factor != 1.0
                                      or postscale_factor != 1.0):
            raise ValueError("Adasum is scale-invariant; pre/post scale "
                             "factors do not apply")
        # (reducer, ranks) of every bucket; over a process set it is made
        # at the first bucket, since the optimizer may precede init()
        self._reducer = None
        self._reducer_gen = None  # the runtime generation it was made in
        self._negotiate = mesh_spec is None  # the composed sync is traced
        if mesh_spec is not None:
            from ..parallel import mesh as composed
            if process_set is not None or sparse_gradient_paths:
                raise ValueError("mesh_spec reduces over the layout: it "
                                 "takes no process_set and no "
                                 "sparse_gradient_paths")
            # its groups: every rank, in one order
            self._reducer = composed.step_reducer(
                composed.layout_of(mesh_spec), op)
        self.optimizer = optimizer
        self._pset = _resolve(process_set)
        self._op, self._compression = op, compression
        self._pre, self._post = prescale_factor, postscale_factor
        self._k = backward_passes_per_step
        params, seen = [], set()
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and id(p) not in seen:
                    seen.add(id(p))
                    params.append(p)
        self._params = params
        names = {id(p): n for n, p in (named_parameters or ())}
        if sparse_gradient_paths and not names:
            raise ValueError("sparse_gradient_paths needs named_parameters="
                             "(the names its regexes are matched against)")
        self._sparse, self._dense = [], []
        for p in params:
            rows = _sparse_rows_for(names.get(id(p), ""),
                                    sparse_gradient_paths, sparse_max_rows)
            if rows is not None and p.dim() == 2:
                self._sparse.append((p, rows))
            else:
                self._dense.append(p)
        sizes = [p.numel() * p.element_size() for p in self._dense]
        cap = envs.bucket_bytes()
        if not sizes:
            self._buckets = []
        elif cap <= 0:
            self._buckets = [list(range(len(sizes)))]
        else:
            self._buckets = _bucket_layout(sizes, cap)
        self._bucket_of = {id(self._dense[i]): b
                           for b, idxs in enumerate(self._buckets)
                           for i in idxs}
        self.stats = {"bucket_bytes": [sum(sizes[i] for i in idxs)
                                       for idxs in self._buckets],
                      "sparse_rows": [rows for _, rows in self._sparse],
                      "started_in_backward": []}
        self._acc: dict = {}  # id(p) -> float32 running mean of passes
        self._micro = 0  # passes folded since the last reducing step
        self._synced = False
        self._region = None  # the pass's step-capture region, while open
        self._reset_pass()
        # every rank is in the global set: no runtime query before init()
        self._member = process_set is None or self._pset.included()
        if self._member:
            ref = weakref.ref(self)

            def hook(p):
                opt = ref()
                if opt is not None:
                    opt._landed(p)

            for p in self._dense:
                p.register_post_accumulate_grad_hook(hook)

    def __getattr__(self, name):
        if name == "optimizer":  # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.optimizer, name)

    def _reset_pass(self) -> None:
        self._landed_ids: set = set()
        self._counts = [0] * len(self._buckets)
        self._handles: list = [None] * len(self._buckets)
        self._next = 0  # the next bucket to start
        self._in_backward = 0

    def abandon_pass(self) -> None:
        """Forget the pass in flight: its gradients were not all reduced
        (a peer died mid-step) and the elastic restore rolls the step
        back, so the re-run's backward pass starts a fresh one. The
        capture region the pass opened died with the aborted world."""
        self._reset_pass()
        self._region = None
        self._synced = False
        self._micro = 0
        self._acc = {}

    def _landed(self, p) -> None:
        """Gradient hook: ``p.grad`` holds this pass's gradient. Starts every
        bucket that is complete and next in order; only on the pass that
        reduces."""
        if self._micro != self._k - 1 or self._synced:
            return
        if id(p) in self._landed_ids:
            raise RuntimeError(
                "Gradients were computed more than backward_passes_per_step "
                "times before call to step(). Increase "
                "backward_passes_per_step to accumulate gradients locally.")
        self._landed_ids.add(id(p))
        self._counts[self._bucket_of[id(p)]] += 1
        while (self._next < len(self._buckets) and self._counts[self._next]
               == len(self._buckets[self._next])):
            self._start(self._next)
            self._in_backward += 1

    def _grad(self, p) -> torch.Tensor:
        """What ``p`` sends: this pass's gradient (zeros if none landed),
        or with ``backward_passes_per_step`` k the mean of the k passes'."""
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if self._k == 1:
            return g
        acc = self._acc[id(p)]
        return (acc + (g.float() - acc) / self._k).to(p.dtype)

    def _start(self, b: int) -> None:
        with timeline.span(timeline.OPTIMIZER_LANE, "BUCKET_START"):
            self._hand_off(b)

    def _hand_off(self, b: int) -> None:
        """Gather bucket ``b``'s gradients and hand them to the fusion
        cycle (or issue them at once), and issue the bucket before it."""
        grads = [self._grad(self._dense[i]) for i in self._buckets[b]]
        h = None
        # mesh_spec's composed reducer issues at once, and so does every
        # bucket while the stream is captured (a cached step): on the
        # capturing stream, not on the fusion cycle's executor thread
        capturing = grads[0].is_cuda \
            and torch.cuda.is_current_stream_capturing()
        if self._negotiate and not capturing:
            if b == 0 and self._region is None:
                self._region = step_capture.auto_region().__enter__()
            h = fusion_cycle.queue_allreduce(
                grads, grouped=True, op=self._op, process_set=self._pset,
                prescale_factor=self._pre, postscale_factor=self._post,
                compression=self._compression)
        if h is not None:
            h.flush()  # the bucket trigger: issued now, in bucket order
            self._handles[b] = h
        else:
            if self._negotiate and self._reducer_gen != runtime.generation():
                self._reducer = None  # of a world that re-formed since
            if self._reducer is None:
                self._reducer = (collectives._reducer(self._pset, self._op),
                                 self._pset.size())
                self._reducer_gen = runtime.generation()
            reduce, size = self._reducer
            self._handles[b] = collectives._reduce_async(
                grads, op=self._op, prescale_factor=self._pre,
                postscale_factor=self._post, compression=self._compression,
                size=size, reduce=reduce,
                negotiate=self._pset if self._negotiate else None)
        if b:
            # a negotiated bucket is issued at the next one's start, or at
            # synchronize(): a point of the program, the same on every rank
            # (where its plan arrives is not), so it keeps its place among
            # the other collectives of the world's communicator
            self._handles[b - 1].issue()
        self._next = b + 1

    def _fold(self) -> None:
        """Fold this pass's gradients into the running mean (MultiSteps'
        ``acc + (g - acc) / (n + 1)``), in float32 tensors of its own."""
        n = self._micro + 1
        for p in self._params:
            acc = self._acc.get(id(p))
            if acc is None:
                acc = self._acc[id(p)] = torch.zeros_like(
                    p, dtype=torch.float32)
            if p.grad is not None:
                acc.add_((p.grad.float() - acc) / n)
            else:
                acc.sub_(acc / n)

    def _sparse_sync(self, p, max_rows: int) -> torch.Tensor:
        """One sparse-routed gradient, scaled and compressed as the dense
        ones (reference ``_allreduce_tree``)."""
        g = self._grad(p)
        if self._pre != 1.0:
            g = g * self._pre
        c, ctx = self._compression.compress(g)
        out = sparse_ops.sparse_allreduce_to_dense(
            c, max_rows, op=self._op, process_set=self._pset)
        out = self._compression.decompress(out, ctx)
        return out if self._post == 1.0 else out * self._post

    def synchronize(self) -> None:
        """Finish the reduction of this pass: start the buckets that are
        left, reduce the sparse-routed gradients, wait, and write every
        result to ``.grad``. A following ``step()`` does not reduce again.
        On the first k-1 passes of ``backward_passes_per_step`` k there is
        nothing to reduce yet."""
        if self._synced or self._micro != self._k - 1:
            return
        if gspmd_cache.recording():
            gspmd_cache.note_passthrough()
        if self._member:
            for b in range(self._next, len(self._buckets)):
                self._start(b)
            sparse = [(p, self._sparse_sync(p, rows))
                      for p, rows in self._sparse]
            self.stats["started_in_backward"].append(self._in_backward)
            try:
                for idxs, h in zip(self._buckets, self._handles):
                    with timeline.span(timeline.OPTIMIZER_LANE, "SYNC_WAIT"):
                        h.wait()
                    with timeline.span(timeline.OPTIMIZER_LANE,
                                       "SYNC_UNPACK"):
                        for i, r in zip(idxs, h.synchronize()):
                            _set_grad(self._dense[i], r)
            finally:
                if self._region is not None:
                    region, self._region = self._region, None
                    region.__exit__(None, None, None)
            for p, r in sparse:
                p.grad = r
        self._reset_pass()
        self._synced = True

    def step(self, closure=None):
        """On the first k-1 of every ``backward_passes_per_step`` k calls,
        fold ``.grad`` into the running mean; on the k-th, reduce (unless
        :meth:`synchronize` already did) and step the wrapped optimizer."""
        if self._micro < self._k - 1:
            self._fold()
            self._micro += 1
            return None
        self.synchronize()
        self._synced = False
        self._micro = 0
        self._acc = {}
        with timeline.span(timeline.OPTIMIZER_LANE, "OPTIMIZER_STEP"):
            return self.optimizer.step(closure)


def _set_grad(p, r) -> None:
    """``p.grad = r``, written into the gradient in place where one of its
    shape and dtype is there: the gradients keep their addresses from
    step to step (which a captured step's CUDA Graph reads), as the DDP
    reducer's gradient views do."""
    g = p.grad
    if g is None or g is r or g.shape != r.shape or g.dtype != r.dtype:
        p.grad = r
    else:
        g.copy_(r)


def _flatten(x):
    """The tensors of a tensor, or of a (nested) list, tuple or dict of
    them, and the function that puts new tensors in their places."""
    if isinstance(x, torch.Tensor):
        return [x], lambda ts: ts[0]
    keys = list(x) if isinstance(x, dict) else range(len(x))
    parts = [_flatten(x[k]) for k in keys]

    def build(ts):
        out, i = [], 0
        for sub, b in parts:
            out.append(b(ts[i:i + len(sub)]))
            i += len(sub)
        return dict(zip(keys, out)) if isinstance(x, dict) else type(x)(out)

    return [t for sub, _ in parts for t in sub], build


def value_and_grad(fun, argnums=0, has_aux: bool = False, *,
                   op: ReduceOp = ReduceOp.AVERAGE,
                   process_set: ProcessSet | None = None,
                   compression: type[Compressor] = Compression.none,
                   mesh_spec=None):
    """``jax.value_and_grad`` over ``torch.autograd.grad`` with the
    gradients allreduced (reference ``value_and_grad``, the
    ``DistributedGradientTape`` analog). ``argnums`` (an int or a tuple)
    picks the arguments to differentiate; each is a tensor or a list,
    tuple or dict of tensors, and its gradient has its structure. The
    value is not reduced; with ``has_aux`` it is ``(value, aux)``.
    ``mesh_spec`` (a ``parallel.mesh.MeshLayout``, or the name pair of its
    data axes) reduces two-level over the layout's data axes instead
    (``parallel.mesh.sync_gradients``; no compressor, as there)."""
    if mesh_spec is not None and process_set is not None:
        raise ValueError("mesh_spec reduces over the layout: it takes no "
                         "process_set")

    def wrapped(*args, **kwargs):
        nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)
        args = list(args)
        leaves, builds = [], []
        for i in nums:
            ts, build = _flatten(args[i])
            ts = [t.detach().requires_grad_() for t in ts]
            args[i] = build(ts)
            leaves.append(ts)
            builds.append(build)
        flat = [t for ts in leaves for t in ts]
        with torch.enable_grad():
            out = fun(*args, **kwargs)
        value = out[0] if has_aux else out
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(torch.autograd.grad(value, flat,
                                                     allow_unused=True),
                                 flat)]
        if mesh_spec is not None:
            from ..parallel import mesh as composed
            grads = composed.sync_gradients(
                grads, composed.layout_of(mesh_spec), op=op)
        else:
            grads = collectives.grouped_allreduce(
                grads, op=op, process_set=process_set,
                compression=compression)
        structured, i = [], 0
        for ts, build in zip(leaves, builds):
            structured.append(build(grads[i:i + len(ts)]))
            i += len(ts)
        g_out = structured[0] if isinstance(argnums, int) else tuple(
            structured)
        value = value.detach()
        return ((value, out[1]) if has_aux else value), g_out

    return wrapped


def grad(fun, argnums=0, has_aux: bool = False, **kwargs):
    """``jax.grad`` with allreduced gradients (reference ``grad``). With
    ``has_aux=True`` returns ``(grads, aux)``."""
    vg = value_and_grad(fun, argnums=argnums, has_aux=has_aux, **kwargs)

    def wrapped(*args, **kw):
        value, grads = vg(*args, **kw)
        if has_aux:
            return grads, value[1]
        return grads

    return wrapped
