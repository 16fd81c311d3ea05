"""The cached whole training step: ``hvd.cached_step`` (port of
``horovod_tpu/ops/gspmd_cache.py``).

The JAX package keys a lowered and compiled ``jit`` step on a stable step
signature, because ``jax.jit`` keys its own cache on the step closure's
identity and a re-created closure would trace again. The port's
counterpart of a compiled step is a **CUDA Graph of the whole step**: the
forward (with the flash kernel), the loss, the backward (with both flash
gradient kernels), ``DistributedOptimizer``'s gradient sync and the
optimizer's update, launched with one ``replay()``.

:func:`cached_step` keeps the reference's contract:

* The **step signature** is the argument tree's structure, each leaf's
  shape, dtype and device (a Python scalar is a constant of the graph, so
  its value is part of it), and a content fingerprint of the step
  function: its module, qualname, code object and primitive closure cells,
  never ``id()``. It is folded by :func:`~.dispatch_cache.fold_knobs` and
  stored in the dispatch plan cache under the ``gspmd`` source, so every
  invalidation path there (the knob epoch, the runtime generation, LRU,
  ``HVD_CACHE_CAPACITY=0``) applies unchanged. Two ``cached_step``
  wrappers over re-created closures of one function share a plan.
* **Recording.** The first call of a signature runs the step eagerly: that
  is the step's real work. On the card it then captures the step into a
  ``torch.cuda.CUDAGraph`` over static copies of the arguments. A capture
  executes nothing, so the recording call updates the model once. A hit
  copies the new arguments into the static copies and replays.
* **What a graph reads.** The plan records the address and strides of
  every parameter, buffer, gradient and optimizer-state tensor of the
  modules and optimizers the step reaches, and of every tensor it reaches
  bare, with each optimizer's hyperparameters (``lr``, ``betas``,
  ``weight_decay``, ...: a float is a constant of the graph). The step
  reaches what its closure cells and the globals its code names hold (a
  bound method: its object), and from there two steps further through
  containers, plain objects' attributes and helper functions' closures and
  globals. A plan whose tensors moved (a re-created optimizer, a
  ``load_state_dict`` that replaced tensors, a gradient set to ``None``
  outside the step) or whose hyperparameters changed (an LR scheduler
  stepped between calls, ``TorchState.restore`` setting another ``lr``)
  is the port's "executable rejected its inputs": the plan is dropped, the
  call runs plain, and the next call records again. An LR that changes
  every step is better a tensor (``Adam(lr=torch.tensor(...),
  capturable=True)``): the graph reads its memory, so a scheduler that
  writes it in place keeps the plan.
* **A step that cannot be captured** (a host sync such as ``.item()``
  inside it, ``backward_passes_per_step`` above 1, whose passes differ, a
  step that changes hyperparameters itself, or on the card a step whose
  capture reads a tensor that is neither an argument nor reached as
  above, so that no check could see it move) is stored ``UNPLANNABLE``
  with a warning and runs plain calls, counted in ``events["fallback"]``.
  A wrapped torch optimizer that is not ``capturable`` is refused on the
  card with an error: its step count would be a host value baked into the
  graph. So is a numpy argument there: pass tensors.
* **Host effects.** The step's Python runs at a record only (on the card
  twice: the eager run and the capture), never at a replay.
* **On the host** there is no graph: a hit runs the step as a plain call,
  which is the plain version the tests hold, as slice 10's replay does.
* **Donation.** With donation the outputs of a replay are the graph's own
  tensors, which the next replay overwrites; without it they are clones.
  ``"auto"`` donates on the card (``HVD_GSPMD_CACHE_DONATE``).
* **Under a negotiation service** the step runs plain calls, counted as
  ``bypass``: the JAX cached step is traced and never negotiates, and the
  negotiated path's whole-step form is the step capture of
  ``ops/step_capture.py``.

While a step records, ``DistributedOptimizer`` counts its syncs in
``passthrough_syncs`` (frozen while the step replays), and while its
stream is captured the optimizer issues its buckets at once on the
capturing stream, not through the fusion cycle's executor thread: NCCL's
work joins the captured stream at ``synchronize()``, so the buckets still
overlap the backward pass inside the graph.

Knobs: ``HVD_GSPMD_CACHE`` (default on; 0 runs plain calls),
``HVD_GSPMD_CACHE_DONATE`` (auto|1|0).
"""

from __future__ import annotations

import types

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .. import metrics as _metrics
from .. import timeline as _timeline
from ..utils import envs
from ..utils import logging as hvd_logging
from ..utils.tree import flatten as tree_flatten
from ..utils.tree import unflatten as tree_unflatten
from . import dispatch_cache as _dispatch
from .step_capture import _PHASE_CODES

_recording = 0  # steps recording now (the eager run or the capture)


def recording() -> bool:
    """Whether a cached step is recording (its eager run or its capture)."""
    return _recording > 0


# ---------------------------------------------------------------------------
# step-signature canonicalizer
# ---------------------------------------------------------------------------

def leaf_signature(leaf) -> tuple:
    """(shape, dtype, weak_type, placement) of one argument leaf, the
    reference's per-leaf canonicalizer. A tensor's placement is its device
    and whether it requires grad; a numpy array is signed by its shape and
    dtype, as the reference's aval (the card refuses it); a Python scalar
    is a constant of the graph, so its value stands where the reference's
    weak-typed aval is."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."),
                False, ("device", str(leaf.device),
                        bool(leaf.requires_grad)))
    if isinstance(leaf, np.ndarray):
        return (tuple(leaf.shape), str(leaf.dtype), False, ("numpy",))
    return ((), type(leaf).__name__, True, ("const", leaf))


def tree_signature(args: tuple) -> tuple:
    """Signature of an argument tree: (structure, per-leaf signatures).
    Two structurally identical trees of different objects give equal
    signatures."""
    leaves, treedef = tree_flatten(args)
    return (treedef, tuple(leaf_signature(leaf) for leaf in leaves))


def _code_fingerprint(fn) -> tuple:
    """Content identity of the step function, stable across closure
    re-creation: module, qualname, the code object (hashed by content; a
    nested ``def`` run again by its builder reuses one code constant) and
    the primitive closure cells. A captured object adds only its type:
    its state is the plan's recorded tensor layout."""
    code = getattr(fn, "__code__", None)
    cells = []
    for cell in (getattr(fn, "__closure__", None) or ()):
        contents = cell.cell_contents
        if isinstance(contents, (str, bytes, int, float, bool, type(None))):
            cells.append(("lit", contents))
        else:
            cells.append(("obj", type(contents).__module__,
                          type(contents).__qualname__))
    return (getattr(fn, "__module__", ""), getattr(fn, "__qualname__", ""),
            code, tuple(cells))


# ---------------------------------------------------------------------------
# what a step reaches: its modules and optimizers
# ---------------------------------------------------------------------------

_REACH_DEPTH = 2  # steps past a closure cell, global or bound object
_REACH_WIDTH = 256  # items of one container looked at


class _Reach:
    """What a step reaches (:func:`_step_objects`)."""

    __slots__ = ("modules", "optimizers", "wrappers", "tensors")

    def __init__(self):
        self.modules, self.optimizers = [], []
        self.wrappers, self.tensors = [], []


def _step_objects(fn) -> _Reach:
    """The ``nn.Module``s, torch optimizers, ``DistributedOptimizer``s and
    bare tensors the step reaches: what its closure cells and the globals
    its code names hold (a bound method: its object), and from there up to
    ``_REACH_DEPTH`` steps further through containers, plain objects'
    attributes and functions' closures and globals. Modules, classes and
    the contents of modules and optimizers are not walked into."""
    from ..optim import DistributedOptimizer
    seen: set = set()
    reach = _Reach()

    def visit(obj, depth):
        if id(obj) in seen or isinstance(
                obj, (str, bytes, int, float, bool, type(None), type,
                      types.ModuleType, np.ndarray)):
            return
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            reach.tensors.append(obj)
        elif isinstance(obj, torch.nn.Module):
            reach.modules.append(obj)
        elif isinstance(obj, DistributedOptimizer):
            reach.wrappers.append(obj)
            visit(obj.optimizer, depth)
        elif isinstance(obj, torch.optim.Optimizer):
            reach.optimizers.append(obj)
        elif isinstance(obj, types.FunctionType):
            walk(obj, depth + 1)
        elif isinstance(obj, types.MethodType):
            visit(obj.__self__, depth)
            walk(obj.__func__, depth)
        elif depth >= _REACH_DEPTH:
            return
        elif isinstance(obj, (list, tuple, set, frozenset)):
            for x in list(obj)[:_REACH_WIDTH]:
                visit(x, depth + 1)
        elif isinstance(obj, dict):
            for x in list(obj.values())[:_REACH_WIDTH]:
                visit(x, depth + 1)
        elif hasattr(obj, "__dict__"):
            for x in list(vars(obj).values())[:_REACH_WIDTH]:
                visit(x, depth + 1)

    def walk(f, depth):
        if depth > _REACH_DEPTH:
            return
        for cell in (getattr(f, "__closure__", None) or ()):
            try:
                visit(cell.cell_contents, depth)
            except ValueError:  # an empty cell
                pass
        code = getattr(f, "__code__", None)
        glb = getattr(f, "__globals__", {})
        for name in (code.co_names if code is not None else ()):
            if name in glb:
                visit(glb[name], depth)

    if isinstance(fn, types.MethodType):
        visit(fn.__self__, 0)
        walk(fn.__func__, 0)
    else:
        walk(fn, 0)
    return reach


def _read_tensors(reach: _Reach) -> list:
    """Every tensor a graph of the step may read or write in place: the
    modules' parameters, buffers, gradients and plain tensor attributes,
    the optimizers' parameters, gradients, state and tensor
    hyperparameters, and the bare tensors with their gradients (None for a
    missing gradient)."""
    out = []
    for m in reach.modules:
        for p in m.parameters():
            out += [p, p.grad]
        out += list(m.buffers())
        for sub in m.modules():
            out += [v for v in vars(sub).values()
                    if isinstance(v, torch.Tensor)]
    for opt in reach.optimizers:
        for group in opt.param_groups:
            for p in group["params"]:
                out += [p, p.grad]
                state = opt.state.get(p, {})
                out += [state[k] for k in sorted(state)
                        if isinstance(state[k], torch.Tensor)]
            out += [v for k, v in sorted(group.items())
                    if k != "params" and isinstance(v, torch.Tensor)]
    for t in reach.tensors:
        out += [t, t.grad]
    return out


def _hyper(value):
    """A hyperparameter as the graph sees it: a tensor by its address (the
    graph reads its memory), anything else by value (a constant of it)."""
    if isinstance(value, torch.Tensor):
        return ("tensor", value.data_ptr(), tuple(value.stride()))
    if isinstance(value, (list, tuple)):
        return tuple(_hyper(v) for v in value)
    return value


def _hyperparameters(reach: _Reach) -> tuple:
    """Each optimizer's param_groups without their parameters."""
    return tuple(tuple(tuple((k, _hyper(v)) for k, v in sorted(g.items())
                             if k != "params")
                       for g in opt.param_groups)
                 for opt in reach.optimizers)


def _layout(reach: _Reach) -> tuple:
    """What a graph of the step reads, in the form its check compares:
    each tensor's ``data_ptr`` and strides (``step_capture._layout``),
    None for a missing gradient, and the optimizers' hyperparameters."""
    return (tuple(None if t is None else (t.data_ptr(), tuple(t.stride()))
                  for t in _read_tensors(reach)),
            _hyperparameters(reach))


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _OutsideReads(TorchDispatchMode):
    """The tensors a run of the step reads that none of its own ops made:
    what a graph of it reads from outside. Every op the run issues on
    this thread and on autograd's threads passes here (the mode is part
    of the thread-local state autograd carries); ``torch.tensor``'s
    literal is the op's own (``lift_fresh``)."""

    _LITERAL = {"aten.lift_fresh.default", "aten.lift_fresh_copy.default"}

    def __init__(self):
        super().__init__()
        self.made: set = set()
        self.read: dict = {}  # storage address -> (op, shape, dtype)

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        literal = str(func) in self._LITERAL
        if not literal:
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    addr = _storage(t)
                    if addr and addr not in self.made \
                            and addr not in self.read:
                        self.read[addr] = (str(func), tuple(t.shape),
                                           t.dtype)
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                addr = _storage(t)
                if addr not in self.read:
                    self.made.add(addr)
        return out

    def untracked(self, known) -> list:
        """The outside reads of tensors not in ``known``: (op, shape,
        dtype) each."""
        addrs = {_storage(t) for t in known if isinstance(t, torch.Tensor)}
        return [v for a, v in self.read.items() if a not in addrs]


def _check_capturable(reach: _Reach, args) -> str | None:
    """Refuse an optimizer whose step count is a host value and a numpy
    argument (raises), and name what makes a step uncapturable (None when
    nothing does)."""
    if any(isinstance(x, np.ndarray) for x in tree_flatten(args)[0]):
        raise TypeError(
            "cached_step: a numpy argument would be read from host memory "
            "a CUDA Graph cannot follow; pass tensors (torch.from_numpy(x)"
            ".to(device) before the call)")
    for opt in reach.optimizers:
        for group in opt.param_groups:
            if "capturable" in group and not group["capturable"]:
                raise ValueError(
                    f"cached_step: {type(opt).__name__} was built with "
                    "capturable=False, so its step count is a host value a "
                    "CUDA Graph would freeze; build it with "
                    "capturable=True")
    for w in reach.wrappers:
        if w._k > 1:
            return ("DistributedOptimizer(backward_passes_per_step="
                    f"{w._k}) runs different passes in turn")
    return None


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class GspmdPlan(_dispatch.DispatchPlan):
    """A cached whole step in the dispatch plan cache. On the card
    ``graph`` holds the captured step, ``static_args`` the tensors it
    reads its arguments from and ``static_out`` its outputs; on the host
    ``graph`` is None and a hit runs the step as a plain call. ``layout``
    is the recorded addresses of what the step reads (:func:`_layout`); on
    the host it is taken again after each plain replay, since the step's
    own ``zero_grad()`` may give the gradients new tensors there. No
    negotiation and no payload accounting (``nbytes`` None). The plan
    holds no reference to itself (``run`` replays; ``execute`` is unused),
    so a plan the cache drops frees its graph at once: NCCL destroys a
    communicator only after every graph holding its work is gone, and
    ``shutdown()`` drops the plans just before it destroys the groups."""

    __slots__ = ("key", "donate", "graph", "static_args", "static_out",
                 "layout")

    def __init__(self, key: tuple, donate: bool, layout: tuple,
                 graph=None, static_args=None, static_out=None):
        super().__init__("gspmd", "GSPMD_STEP", None, None, None,
                         variant="gspmd")
        self.key = key
        self.donate = donate
        self.layout = layout
        self.graph = graph
        self.static_args = static_args
        self.static_out = static_out

    def run(self, call):
        with _timeline.op_range(self.label, self.activity):
            return self._replay(call)

    def _replay(self, call):
        fn, args = call
        if self.graph is None:
            return fn(*args)
        for dst, src in zip(self.static_args, tree_flatten(args)[0]):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src, non_blocking=True)
        self.graph.replay()
        if self.donate:
            return self.static_out
        leaves, treedef = tree_flatten(self.static_out)
        return tree_unflatten(treedef, [
            x.clone() if isinstance(x, torch.Tensor) else x for x in leaves],
            self.static_out)



def _note_gspmd(event: str | None = None, state: str | None = None) -> None:
    """Mirror a lifecycle event and/or phase onto the metrics registry
    (the step-capture vocabulary)."""
    if event is not None:
        _metrics.GSPMD_CACHE_STEPS.inc(labels={"event": event})
    if state is not None:
        _metrics.GSPMD_CACHE_PHASE.set(_PHASE_CODES.get(state, 0))


_capture_streams: dict = {}


def _capture_stream(device: torch.device):
    """The stream a cached step is captured on (one a device)."""
    stream = _capture_streams.get(device)
    if stream is None:
        stream = _capture_streams[device] = torch.cuda.Stream(device)
    return stream


def _reset_wrappers(wrappers) -> None:
    """Return each ``DistributedOptimizer`` to the start of a pass after a
    capture that failed midway (its hooks and ``step()`` ran in part)."""
    for w in wrappers:
        if w._region is not None:
            region, w._region = w._region, None
            region.__exit__(None, None, None)
        w._reset_pass()
        w._synced = False
        w._micro = 0
        w._acc = {}


# ---------------------------------------------------------------------------
# the cached step
# ---------------------------------------------------------------------------

class CachedStep:
    """Callable wrapper around one step function (see :func:`cached_step`).
    Holds no plan itself: plans live in the dispatch plan cache, so two
    wrappers over re-created closures of one function serve each other's,
    and every cache-wide invalidation applies."""

    def __init__(self, fn, donate="auto"):
        self._fn = fn
        self._donate = donate
        self._fingerprint = _code_fingerprint(fn)
        self._traces = 0

    @property
    def traces(self) -> int:
        """Times the step's Python ran outside a replay through this
        wrapper: a record's eager run and its capture, and every plain
        call (bypass, fallback). A warm step replays with it frozen."""
        return self._traces

    def _run(self, args, record: bool):
        global _recording
        self._traces += 1
        _recording += record
        try:
            return self._fn(*args)
        finally:
            _recording -= record

    @staticmethod
    def _platform(args) -> str:
        for leaf in tree_flatten(args)[0]:
            if isinstance(leaf, torch.Tensor):
                return leaf.device.type
        from .. import runtime
        return (runtime.device().type if runtime.is_initialized()
                else "cpu")

    def _donates(self, platform: str) -> bool:
        if self._donate == "auto":
            return envs.gspmd_donate_enabled(platform)
        return bool(self._donate)

    def _store_key(self, args: tuple) -> tuple:
        """The plan-cache key: the step signature and the raw donation
        decision (an ``os.environ`` change moves no epoch)."""
        tag = (self._donate == "auto",
               self._donates(self._platform(args)))
        return _dispatch.fold_knobs(
            "gspmd", (self._fingerprint,) + tree_signature(args), tag)

    def _plain(self, args):
        return self._run(args, record=False)

    def _capture(self, args, reach: _Reach, donate: bool):
        """Capture the step into a CUDA Graph over static copies of
        ``args``; returns the plan's graph pieces, or None where the step
        cannot be captured or its graph reads a tensor the plan cannot
        track (warned)."""
        global _recording
        leaves, treedef = tree_flatten(args)
        static = [x.detach().clone().requires_grad_(x.requires_grad)
                  if isinstance(x, torch.Tensor) else x for x in leaves]
        static_args = tree_unflatten(treedef, static, args)
        device = next((x.device for x in leaves
                       if isinstance(x, torch.Tensor) and x.is_cuda),
                      torch.device("cuda", torch.cuda.current_device()))
        stream = _capture_stream(device)
        graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(device))
        self._traces += 1
        _recording += 1
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                with _OutsideReads() as reads:
                    static_out = self._fn(*static_args)
        except Exception as exc:
            _reset_wrappers(reach.wrappers)
            hvd_logging.warning(
                "gspmd_cache: the step cannot be captured into a CUDA "
                "Graph (%s); serving plain calls for this signature", exc)
            return None
        finally:
            _recording -= 1
        torch.cuda.current_stream(device).wait_stream(stream)
        untracked = reads.untracked(_read_tensors(reach) + static)
        if untracked:
            hvd_logging.warning(
                "gspmd_cache: the captured step reads %d tensor(s) that are "
                "neither arguments nor reached through its closure, "
                "globals or object (first: %s), so no check could see them "
                "move; serving plain calls for this signature",
                len(untracked), untracked[0])
            return None
        return graph, static, static_out

    def __call__(self, *args):
        from .. import engine_service
        from ..process_sets import _resolve
        if not envs.gspmd_cache_enabled() \
                or engine_service.get_service(_resolve(None)) is not None:
            _note_gspmd("bypass", state="bypass")
            return self._plain(args)
        key = self._store_key(args)
        # record_stats=False: a hit counts when the replay serves
        # (note_gspmd_hit below), as the capture controller's does
        plan = _dispatch.lookup(key, record_stats=False)
        if plan is _dispatch.UNPLANNABLE:
            return self._plain(args)
        if plan is not None:
            reach = _step_objects(self._fn)
            if _layout(reach) != plan.layout:
                # the graph would read tensors that moved, or constants
                # that changed: the reference's "executable rejected its
                # inputs"
                hvd_logging.warning(
                    "gspmd_cache: a tensor of the cached step moved or an "
                    "optimizer hyperparameter changed; dropping the plan "
                    "and running a plain call")
                _dispatch.drop(key)
                _note_gspmd("invalidated")
                _note_gspmd("fallback", state="bypass")
                return self._plain(args)
            out = plan.run((self._fn, args))
            if plan.graph is None:
                plan.layout = _layout(reach)
            _dispatch.note_gspmd_hit()
            _note_gspmd("replayed", state="replayed")
            return out
        return self._record(args, key)

    def _record(self, args, key):
        _note_gspmd(state="record")
        platform = self._platform(args)
        reach = _step_objects(self._fn)
        why = None
        if platform == "cuda":
            why = _check_capturable(reach, args)
        hyper = _hyperparameters(reach)
        out = self._run(args, record=True)  # the step's real work
        if why is None and _hyperparameters(reach) != hyper:
            why = ("the step changes its optimizers' hyperparameters on the "
                   "host (an LR scheduler inside it?), which a graph would "
                   "freeze")
        donate = self._donates(platform)
        pieces = None
        if platform == "cuda" and why is None:
            pieces = self._capture(args, reach, donate)
            if pieces is None:
                why = "capture failed"
        elif why is not None:
            hvd_logging.warning(
                "gspmd_cache: the step cannot be captured (%s); serving "
                "plain calls for this signature", why)
        if why is not None:
            _dispatch.store(key, _dispatch.UNPLANNABLE)
            _note_gspmd("fallback", state="bypass")
            return out
        plan = GspmdPlan(key, donate, _layout(reach))
        if pieces is not None:
            plan.graph, plan.static_args, plan.static_out = pieces
        _dispatch.store(key, plan)
        _note_gspmd("recorded")
        return out


def cached_step(fn, donate="auto") -> CachedStep:
    """Wrap a whole training step in the cached-step fast path.

    ``step = hvd.cached_step(train_step)`` then ``loss = step(batch)``:
    ``train_step`` runs forward, loss, ``backward()`` and ``opt.step()``
    over modules and optimizers it closes over, and returns tensors (call
    ``.item()`` after the call, not inside it). The first call of a
    signature runs eagerly and, on the card, captures the step into a
    CUDA Graph; every later call with the same signature, from this
    wrapper or any other over the same function (a re-created closure
    too), replays it. ``donate`` is ``"auto"`` (the card returns the
    graph's own outputs, overwritten by the next replay), or a truth
    value (any non-empty tuple of argument positions donates)."""
    return CachedStep(fn, donate=donate)


def note_passthrough() -> None:
    """Count one ``DistributedOptimizer`` sync run while a step records:
    once per recording, never per replay (the no-retrace evidence)."""
    _metrics.GSPMD_PASSTHROUGH_SYNCS.inc()


def stats() -> dict:
    """Cached-step counters (``hvd.gspmd_cache_stats()``), the JAX
    package's dict."""
    events = {}
    for labelitems, v in _metrics.GSPMD_CACHE_STEPS.series().items():
        events[dict(labelitems).get("event", "")] = int(v)
    cache = _dispatch.stats()
    return {
        "enabled": envs.gspmd_cache_enabled(),
        "hits": cache["hits_by_source"].get("gspmd", 0),
        "builds": cache["gspmd_builds"],
        "events": events,
        "passthrough_syncs": int(_metrics.GSPMD_PASSTHROUGH_SYNCS.value()),
    }


def reset_stats() -> None:
    for inst in (_metrics.GSPMD_CACHE_STEPS, _metrics.GSPMD_CACHE_PHASE,
                 _metrics.GSPMD_PASSTHROUGH_SYNCS):
        inst.reset()
