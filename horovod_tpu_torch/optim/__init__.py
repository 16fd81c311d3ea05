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

from ..ops import collectives
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
    ``max_rows``). Attributes other than ``step`` and
    ``synchronize`` are the wrapped optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer, *,
                 named_parameters=None,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 process_set: ProcessSet | None = None,
                 compression: type[Compressor] = Compression.none,
                 prescale_factor: float = 1.0, postscale_factor: float = 1.0,
                 backward_passes_per_step: int = 1,
                 sparse_gradient_paths=None, sparse_max_rows=None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self._pset = _resolve(process_set)
        self._op, self._compression = op, compression
        self._pre, self._post = prescale_factor, postscale_factor
        self._sync_kw = dict(op=op, compression=compression,
                             prescale_factor=prescale_factor,
                             postscale_factor=postscale_factor,
                             process_set=self._pset)
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
        grads = [self._grad(self._dense[i]) for i in self._buckets[b]]
        self._handles[b] = collectives.grouped_allreduce_async(
            grads, **self._sync_kw)
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
        if self._member:
            for b in range(self._next, len(self._buckets)):
                self._start(b)
            sparse = [(p, self._sparse_sync(p, rows))
                      for p, rows in self._sparse]
            self.stats["started_in_backward"].append(self._in_backward)
            for idxs, h in zip(self._buckets, self._handles):
                for i, r in zip(idxs, h.synchronize()):
                    self._dense[i].grad = r
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
        return self.optimizer.step(closure)


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
                   compression: type[Compressor] = Compression.none):
    """``jax.value_and_grad`` over ``torch.autograd.grad`` with the
    gradients allreduced (reference ``value_and_grad``, the
    ``DistributedGradientTape`` analog). ``argnums`` (an int or a tuple)
    picks the arguments to differentiate; each is a tensor or a list,
    tuple or dict of tensors, and its gradient has its structure. The
    value is not reduced; with ``has_aux`` it is ``(value, aux)``."""

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
        grads = torch.autograd.grad(value, flat, allow_unused=True)
        grads = collectives.grouped_allreduce(
            [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, flat)],
            op=op, process_set=process_set, compression=compression)
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
