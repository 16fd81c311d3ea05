"""Card-against-CPU checks of the port's convnets, and the reading of a
profiled step's trace, shared by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

:func:`convnet_steps` runs one step of a model from the same weights and
batch in several (device, compute dtype, mode) settings; :func:`step_errors`
compares two of them. TF32 is off for the steps: cuDNN's float32
convolutions use it by default, which would need a 1e-3-scale tolerance.
:func:`pooling_errors` reads the average pool's backward on channels-last
tensors. :func:`backward_overlap` reads from a ``torch.profiler`` trace
whether the gradient allreduce's NCCL kernels ran while the backward pass's
kernels did. :func:`make_process_ray` and :func:`make_process_pyspark` stand
in for the ``ray`` and ``pyspark`` packages with actors and barrier tasks
that are child processes, so that the integrations run a world of NCCL or
gloo ranks, one process each, where neither package is installed.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

# One step from the same weights, the card's against the CPU's in float64:
# the largest logit error relative to the largest logit, the
# relative norm error of all gradients together and of the worst tensor,
# and the largest running-average error.
REFERENCE_LIMITS = {"logits_rel": 1e-3, "grads_rel": 1e-3,
                    "worst_grad_rel": 1e-2, "stats_abs": 1e-3}


def _reference_weights(name: str) -> dict:
    """flax's init from a seed, then BatchNorm scales and biases moved off
    their initial values (the last norm of each residual block to about
    0.2), so that every gradient is live."""
    from horovod_tpu_torch import models
    from horovod_tpu_torch.models import BatchNorm
    model = getattr(models, name)(num_classes=1000, device="cpu",
                                  generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n, s = m.weight.numel(), 0.2 if m.zero_scale else 1.0
                m.weight.copy_(s * (1 + 0.2 * torch.randn(n, generator=g)))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
    return model.state_dict()


def convnet_steps(name: str, size: int, settings, batch: int = 2) -> list:
    """One step of the port's ``name`` (1000 classes, Dropout off) in each
    ``(device, compute dtype, train)`` of ``settings``, from the same
    float32 weights (:func:`_reference_weights`) and the same seeded batch
    of ``size`` x ``size`` images: cross-entropy, backward. Returns, per
    setting, the logits, every parameter's gradient and the running
    averages after the step, on the CPU."""
    from horovod_tpu_torch import models
    state = _reference_weights(name)
    kw = {"dropout_rate": 0.0} if name == "InceptionV3" else {}
    g = torch.Generator().manual_seed(6)
    x = torch.randn((batch, 3, size, size), generator=g)
    y = torch.randint(0, 1000, (batch,), generator=g)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = []
        for device, dtype, train in settings:
            model = getattr(models, name)(num_classes=1000, dtype=dtype,
                                          device=device, **kw)
            model.load_state_dict(state)
            model.train(train)
            logits = model(x.to(device))
            F.cross_entropy(logits, y.to(device)).backward()
            res.append((logits.detach().cpu(),
                        {n: p.grad.cpu() for n, p in model.named_parameters()},
                        {k: t.cpu() for k, t in model.state_dict().items()
                         if k.endswith(("running_mean", "running_var"))}))
            del model, logits
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return res


def step_errors(got, want) -> dict:
    """``got`` against ``want`` (two results of :func:`convnet_steps`), as
    the keys of ``REFERENCE_LIMITS``."""
    (l1, g1, s1), (l0, g0, s0) = got, want
    rel = lambda a, b: ((a.double() - b.double()).norm()
                        / b.double().norm()).item()
    flat = lambda d: torch.cat([d[n].flatten().double() for n in sorted(d)])
    return {"logits_rel": ((l1.double() - l0.double()).abs().max()
                           / l0.double().abs().max()).item(),
            "grads_rel": rel(flat(g1), flat(g0)),
            "worst_grad_rel": max(rel(g1[n], g0[n]) for n in g0),
            "stats_abs": max(((s1[k].double() - s0[k].double()).abs().max()
                              .item() for k in s0), default=0.0)}


def convnet_reference_errors(name: str, size: int, device,
                             dtype=torch.float32, train: bool = True) -> dict:
    """One step of ``name`` on ``device`` computing in ``dtype`` against the
    same step on the CPU in float64 (see :func:`convnet_steps`). float64 is
    the yardstick because the host's own float32 convolutions differ from
    host to host: ResNet-18's float32 gradients from oneDNN on the H100's
    host read 5.3e-3 from float64, the card's 3.0e-5."""
    cpu, card = convnet_steps(name, size, [("cpu", torch.float64, train),
                                           (device, dtype, train)])
    return step_errors(card, cpu)


def pooling_errors(device, shape=(2, 288, 35, 35)) -> dict:
    """The backward of a 3x3 stride-1 average pool with counted padding on
    a channels-last float32 tensor on ``device``, against float64 on the
    CPU: torch's ``avg_pool2d`` itself (``"avg_pool2d"``) and the port's
    :func:`~horovod_tpu_torch.models.layers.avg_pool_same`, each as the
    relative norm error of dx."""
    from horovod_tpu_torch.models.layers import avg_pool_same
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    ct = torch.randn(shape, generator=g, dtype=torch.float64)
    pools = {"avg_pool2d": lambda t: F.avg_pool2d(t, 3, 1, 1,
                                                  count_include_pad=True),
             "avg_pool_same": avg_pool_same}
    want = torch.autograd.grad(pools["avg_pool2d"](x.requires_grad_()), x,
                               ct)[0]
    errs = {}
    for name, pool in pools.items():
        xs = (x.detach().float().to(device)
              .contiguous(memory_format=torch.channels_last).requires_grad_())
        dx = torch.autograd.grad(pool(xs), xs, ct.float().to(device).contiguous(
            memory_format=torch.channels_last))[0]
        errs[name] = ((dx.double().cpu() - want).norm() / want.norm()).item()
    return errs


def backward_overlap(trace_path: str, marker: str = "backward") -> dict:
    """From a ``torch.profiler`` Chrome trace of one step whose backward
    pass ran inside ``record_function(marker)``: the kernels launched while
    it ran (by any thread, through the runtime or the driver), every NCCL
    kernel of the step, and whether the first NCCL kernel started before
    the last backward kernel ended. Times in microseconds from the start of
    the first backward kernel; None where the trace has no such kernel."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == marker
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    nccl = [k for k in kernels if "nccl" in k["name"].lower()]
    found = {"kernels": 0, "nccl_kernels": len(nccl), "overlap": None}
    if not spans:
        return found
    t0 = spans[0]["ts"]
    t1 = t0 + spans[0]["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and t0 <= e["ts"] <= t1
                and "correlation" in e.get("args", {})}
    backward = [k for k in kernels if k not in nccl
                and k.get("args", {}).get("correlation") in launched]
    if not backward:
        return found
    start = min(k["ts"] for k in backward)
    last_end = max(k["ts"] + k["dur"] for k in backward) - start
    first_nccl = min(k["ts"] for k in nccl) - start if nccl else None
    return {**found, "kernels": len(backward),
            "last_backward_kernel_end_us": last_end,
            "first_nccl_start_us": first_nccl,
            "nccl_us_before_backward_end": sum(
                max(0.0, min(k["ts"] + k["dur"] - start, last_end)
                    - max(k["ts"] - start, 0.0)) for k in nccl),
            "overlap": None if first_nccl is None else first_nccl < last_end}


# ---------------------------------------------------------------------------
# Ray and Spark as child processes
# ---------------------------------------------------------------------------
#
# Neither ``ray`` nor ``pyspark`` is installed where the port is tested. The
# two stubs below stand in for them with the same contract as the real
# packages in the respect that matters for a world above one rank: an actor,
# or a barrier task, is a process of its own (``spawn`` context), so each
# rank owns its process group and its card. What crosses a pipe is pickled
# by name: classes and functions must be module-level.

_STUB_DEFAULT_NODE = "127.0.0.1"


class StubRayError(RuntimeError):
    """An actor's call failed, or its process is gone."""


class _Ref:
    """One pending call's result (an ``ObjectRef``)."""

    def __init__(self):
        import threading
        self.event = threading.Event()
        self.ok = None
        self.value = None

    def resolve(self, ok: bool, value) -> None:
        if not self.event.is_set():
            self.ok, self.value = ok, value
            self.event.set()


def _stub_ray_child(node_ip: str, gpu_ids: list):
    """The ``ray`` an actor's process imports: its node's address and the
    GPUs it was given."""
    import types
    mod = types.ModuleType("ray")
    mod.util = types.SimpleNamespace(get_node_ip_address=lambda: node_ip)
    mod.is_initialized = lambda: True
    mod.get_gpu_ids = lambda: list(gpu_ids)
    return mod


def _actor_main(conn, cls, args, kwargs, node_ip: str,
                gpu_ids: list) -> None:
    """An actor's process: make the instance, then serve its method calls
    in order, one at a time, on the process's main thread. An actor given
    GPUs sees only those, as under Ray (``CUDA_VISIBLE_DEVICES``, set
    before anything here starts CUDA)."""
    import os
    import sys
    if gpu_ids:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, gpu_ids))
    sys.modules["ray"] = _stub_ray_child(node_ip, gpu_ids)
    try:
        instance = cls(*args, **kwargs)
        failure = None
    except BaseException as e:  # every call then reports it
        instance, failure = None, e
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        if msg is None:
            return
        call_id, name, a, kw = msg
        try:
            if failure is not None:
                raise failure
            reply = (call_id, True, getattr(instance, name)(*a, **kw))
        except BaseException as e:
            reply = (call_id, False, e)
        try:
            conn.send(reply)
        except Exception as e:  # an unpicklable result or error
            conn.send((call_id, False, StubRayError(
                f"{name}: result not picklable ({e}): {reply[2]!r}")))


class _ProcessActor:
    """The parent's handle of one actor process."""

    def __init__(self, cls, args, kwargs, node_ip: str, gpu_ids=()):
        import itertools
        import multiprocessing
        import threading
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.node_ip = node_ip
        self.gpu_ids = list(gpu_ids)
        self.process = ctx.Process(
            target=_actor_main,
            args=(child, cls, args, kwargs, node_ip, self.gpu_ids),
            daemon=True, name=f"stub-ray-actor-{cls.__name__}")
        self.process.start()
        child.close()
        self._ids = itertools.count()
        self._pending: dict[int, _Ref] = {}
        self._mu = threading.Lock()
        self._send_mu = threading.Lock()
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name="stub-ray-reader")
        self._reader.start()

    def _read(self) -> None:
        while True:
            try:
                call_id, ok, value = self._conn.recv()
            except (EOFError, OSError):
                break
            with self._mu:
                ref = self._pending.pop(call_id, None)
            if ref is not None:
                ref.resolve(ok, value)
        self._fail_pending(StubRayError(
            f"actor process {self.process.pid} ended"))

    def _fail_pending(self, err) -> None:
        with self._mu:
            pending, self._pending = list(self._pending.values()), {}
        for ref in pending:
            ref.resolve(False, err)

    def call(self, name: str, args, kwargs) -> _Ref:
        ref = _Ref()
        with self._mu:
            call_id = next(self._ids)
            self._pending[call_id] = ref
        try:
            with self._send_mu:
                self._conn.send((call_id, name, args, kwargs))
        except (OSError, ValueError) as e:
            with self._mu:
                self._pending.pop(call_id, None)
            ref.resolve(False, StubRayError(f"actor is gone: {e}"))
        return ref

    def kill(self) -> None:
        if self.process.is_alive():
            self.process.terminate()
        self.process.join(30)
        if self.process.is_alive():
            self.process.kill()
            self.process.join(10)
        self._conn.close()
        self._fail_pending(StubRayError("actor killed"))


class _ActorMethod:
    def __init__(self, actor: _ProcessActor, name: str):
        self._actor, self._name = actor, name

    def remote(self, *args, **kwargs) -> _Ref:
        return self._actor.call(self._name, args, kwargs)


class _ActorHandle:
    def __init__(self, actor: _ProcessActor):
        self._actor = actor

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ActorMethod(self._actor, name)


class _RemoteClass:
    def __init__(self, ray, cls, opts=None):
        self._ray, self._cls, self.opts = ray, cls, dict(opts or {})

    def options(self, **opts) -> "_RemoteClass":
        return _RemoteClass(self._ray, self._cls, {**self.opts, **opts})

    def remote(self, *args, **kwargs) -> _ActorHandle:
        node = _STUB_DEFAULT_NODE
        for key in (self.opts.get("resources") or {}):
            if key.startswith("node:"):
                node = key[len("node:"):]
        gpu_ids = self._ray.take_gpus(node, int(self.opts.get("num_gpus")
                                                or 0))
        actor = _ProcessActor(self._cls, args, kwargs, node, gpu_ids)
        self._ray.actors.append(actor)
        return _ActorHandle(actor)


def make_process_ray(nodes: dict | None = None, gpus: int = 0):
    """A stand-in for the ``ray`` module whose actors are processes.
    ``nodes`` is the cluster (node address -> CPUs, 0 for a dead node;
    default one node, ``127.0.0.1``, of one CPU), which ``ray.nodes()``
    reports and a test may change; an actor runs on the node its
    ``node:<address>`` resource names, else on ``127.0.0.1``. ``gpus`` is the
    GPUs each node offers Ray: an actor that asks for ``num_gpus`` gets
    the lowest ids no live actor of its node holds, and sees only those;
    with none offered, an actor sees every card of its node. Install it
    with ``sys.modules["ray"] = make_process_ray()``; ``ray.shutdown()``
    ends every actor still running."""
    import types
    ray = types.ModuleType("ray")
    ray.cluster = dict(nodes or {_STUB_DEFAULT_NODE: 1})
    ray.gpus = int(gpus)
    ray.actors = []
    ray.util = types.SimpleNamespace(
        get_node_ip_address=lambda: _STUB_DEFAULT_NODE)
    ray.get_gpu_ids = lambda: []
    ray.is_initialized = lambda: True

    def take_gpus(node: str, count: int) -> list:
        if count <= 0:
            return []
        held = {i for a in ray.actors if a.node_ip == node
                and a.process.is_alive() for i in a.gpu_ids}
        free = [i for i in range(ray.gpus) if i not in held]
        if len(free) < count:
            raise StubRayError(f"{count} GPU(s) asked of node {node}, "
                               f"{len(free)} free of {ray.gpus}")
        return free[:count]

    ray.take_gpus = take_gpus
    ray.init = lambda *a, **k: None
    ray.remote = lambda cls: _RemoteClass(ray, cls)

    def get(refs):
        if isinstance(refs, list):
            return [get(r) for r in refs]
        refs.event.wait()
        if not refs.ok:
            raise refs.value
        return refs.value

    def wait(refs, timeout=None):
        import time
        deadline = None if timeout is None else time.monotonic() + timeout
        done = []
        for ref in refs:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            if ref.event.wait(left):
                done.append(ref)
        return done, [r for r in refs if r not in done]

    def kill(handle) -> None:
        handle._actor.kill()

    def shutdown() -> None:
        for actor in ray.actors:
            actor.kill()
        ray.actors.clear()

    ray.get, ray.wait, ray.kill, ray.shutdown = get, wait, kill, shutdown
    ray.nodes = lambda: [
        {"NodeManagerAddress": ip, "Alive": cpus > 0,
         "Resources": {"CPU": float(cpus),
                       **({"GPU": float(ray.gpus)} if ray.gpus else {})}}
        for ip, cpus in ray.cluster.items()]
    return ray


class _BarrierTaskContext:
    """A task process's ``BarrierTaskContext``: ``allGather`` goes over
    the task's pipe to the parent, which answers once every task sent."""

    _current = None

    def __init__(self, rank: int, conn):
        self._rank, self._conn = rank, conn

    @classmethod
    def get(cls):
        return cls._current

    def partitionId(self) -> int:
        return self._rank

    def allGather(self, message: str = "") -> list:
        self._conn.send(("gather", message))
        return self._conn.recv()


def _task_main(conn, task, rank: int) -> None:
    """A barrier task's process."""
    import sys
    import types
    mod = types.ModuleType("pyspark")
    mod.BarrierTaskContext = _BarrierTaskContext
    sys.modules["pyspark"] = mod
    _BarrierTaskContext._current = _BarrierTaskContext(rank, conn)
    try:
        reply = ("result", True, list(task(iter(()))))
    except BaseException as e:
        reply = ("result", False, e)
    try:
        conn.send(reply)
    except Exception as e:
        conn.send(("result", False, RuntimeError(
            f"task {rank}: result not picklable ({e})")))


class _ProcessRDD:
    def __init__(self, sc, n: int):
        self._sc, self.n, self._task = sc, n, None

    def barrier(self):
        return self

    def mapPartitions(self, task):
        self._task = task
        return self

    def collect(self) -> list:
        import multiprocessing
        from multiprocessing.connection import wait
        ctx = multiprocessing.get_context("spawn")
        conns, procs = [], []
        for rank in range(self.n):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_task_main,
                               args=(child, self._task, rank), daemon=True,
                               name=f"stub-spark-task-{rank}")
            proc.start()
            child.close()
            conns.append(parent)
            procs.append(proc)
        self._sc.tasks = procs
        gathered: dict[int, str] = {}
        results: dict[int, tuple] = {}
        try:
            while len(results) < self.n:
                live = [c for r, c in enumerate(conns) if r not in results]
                for conn in wait(live, timeout=1.0):
                    rank = conns.index(conn)
                    try:
                        msg = conn.recv()
                    except (EOFError, OSError):
                        results[rank] = (False, RuntimeError(
                            f"barrier task {rank} ended "
                            f"(exit code {procs[rank].exitcode})"))
                        continue
                    if msg[0] == "gather":
                        gathered[rank] = msg[1]
                        if len(gathered) == self.n:
                            everyone = [gathered[r] for r in range(self.n)]
                            for c in conns:
                                c.send(everyone)
                            gathered = {}
                    else:
                        results[rank] = msg[1:]
                if self._sc.cancelled_all:
                    raise RuntimeError("the job group was cancelled")
        finally:
            for proc in procs:
                proc.join(30)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(10)
            for conn in conns:
                conn.close()
        out = []
        for rank in range(self.n):
            ok, value = results[rank]
            if not ok:
                raise value
            out.extend(value)
        return out


class _ProcessSparkContext:
    def __init__(self, default_parallelism: int):
        self.defaultParallelism = default_parallelism
        self.cancelled: list = []
        self.cancelled_all = False
        self.tasks: list = []

    def setJobGroup(self, group, description, interruptOnCancel=False):
        self.group = group

    def cancelJobGroup(self, group) -> None:
        self.cancelled.append(group)
        self.cancelled_all = True
        for proc in self.tasks:
            if proc.is_alive():
                proc.terminate()

    def parallelize(self, data, n: int) -> _ProcessRDD:
        return _ProcessRDD(self, n)


def make_process_pyspark(default_parallelism: int = 1):
    """A stand-in for the ``pyspark`` module whose barrier tasks are
    processes: ``SparkContext._active_spark_context`` is live, and
    ``collect()`` of a barrier ``mapPartitions`` starts one process a task,
    answers their ``allGather`` rounds and returns their results in task
    order. Install it with ``sys.modules["pyspark"] =
    make_process_pyspark()``."""
    import types
    mod = types.ModuleType("pyspark")
    mod.SparkContext = types.SimpleNamespace(
        _active_spark_context=_ProcessSparkContext(default_parallelism))
    mod.BarrierTaskContext = _BarrierTaskContext
    return mod
