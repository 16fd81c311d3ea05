"""One rank of a cell's run: set-up, the checked first steps, the timed
window, the traced block and, on rank 0, the reference.

A one-card cell calls :func:`run_rank` in the command's own process. A
cell on more cards starts one process a card through the program's
launcher, ``python -m horovod_tpu_torch.runner.launch -np N``, each
running ``python -m perfbench.worker`` and writing its result to
``rank<r>.json`` in the directory it is given.

Set-up: ``hvd.init()``; the model built on the card with the seed's
weights; ``broadcast_parameters``; ``DistributedOptimizer`` over the
configuration's optimizer; a pool of distinct batches of this rank drawn
from the seed. Then ``CHECK_STEPS`` steps through the window's own step
function on batches that all differ: after the first, each leaf's
gradient as the optimizer got it is read from the optimizer's state;
after the last, each leaf's change from the initial weights. Then
``WARM_STEPS`` more. On one card the window dispatches steps until
``--seconds`` have passed; on more, the last warm-up steps' time fixes
one count of steps for every rank, which move in lockstep through the
allreduce. In the window, steps are dispatched back to back, with
CUDA events at each step's start and after its ``backward()``; the only
host synchronisation is at its end. With ``--trace 1`` a block of
``PROFILE_STEPS`` steps inside it runs under ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import tempfile
import time

import torch

from . import manifest
from .frozen import imports, trace as trace_mod, weights

CHECK_STEPS = 3  # steps the reference follows
WARM_STEPS = 4  # further steps before the window; the last 3 are timed
POOL = 8  # distinct batches a rank cycles through
PROFILE_AT = 4  # the first profiled step of the window (--trace 1)
PROFILE_STEPS = 3


class _Marks:
    """Step marks: CUDA events on the compute stream, or the host clock
    where the run is on the CPU (the tests)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            return a.elapsed_time(b)
        return (b - a) * 1e3


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _first_grad_norms(base, model, cfg) -> dict:
    """Each leaf's gradient as the optimizer got it at its first step,
    from its state: Adam's first moment over ``1 - beta1``, SGD's
    momentum buffer."""
    hp = cfg["optimizer"]
    key = "exp_avg" if hp["kind"] == "adam" else "momentum_buffer"
    scale = 1 - hp["betas"][0] if hp["kind"] == "adam" else 1.0
    names, norms = [], []
    for name, p in model.named_parameters():
        names.append(name)
        st = base.state.get(p, {})
        # a leaf the optimizer holds no state for got no gradient
        norms.append(st[key].double().norm() / scale if key in st
                     else torch.zeros((), dtype=torch.float64))
    return dict(zip(names, torch.stack([n.cpu() for n in norms]).tolist()))


class _HostClock:
    """What the host did in the window, beside its wall time: the CPU
    seconds of this thread and of the whole process, the threads that
    took the most CPU (name, seconds), and the time spent in and the count
    of the garbage collector's passes."""

    def __init__(self):
        self.gc_s, self.gc_runs, self._t = 0.0, 0, None
        gc.callbacks.append(self._gc)
        self.thread0, self.process0 = time.thread_time(), time.process_time()
        self.threads0 = _threads()

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_runs += 1

    def stop(self) -> dict:
        gc.callbacks.remove(self._gc)
        out = {"thread_cpu_s": time.thread_time() - self.thread0,
               "process_cpu_s": time.process_time() - self.process0,
               "gc_s": self.gc_s, "gc_runs": self.gc_runs}
        now = _threads()
        used = []
        for tid, (name, cpu) in now.items():
            used.append([name, cpu - self.threads0.get(tid, (name, 0.0))[1]])
        out["threads"] = sorted(used, key=lambda u: -u[1])[:6]
        return out


def _threads() -> dict:
    """{thread id: (name, CPU seconds)} of this process's threads, from
    ``/proc/self/task``; a Python thread is named as ``threading`` names
    it. A thread whose entry cannot be read is left out."""
    import threading
    named = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
            comm = stat[stat.index("(") + 1:stat.rindex(")")]
            fields = stat[stat.rindex(")") + 2:].split()
            cpu = (int(fields[11]) + int(fields[12])) / tick
        except (OSError, ValueError, IndexError):
            continue  # the thread ended, or its entry is not the usual one
        out[int(tid)] = (named.get(int(tid), comm), cpu)
    return out


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class Program:
    """The program's side of one rank: set-up, the checked first steps,
    the window. ``hvd`` is initialized by :meth:`setup` and shut down by
    :meth:`close`."""

    def __init__(self, root, workload: str, seed: int, device: str):
        self._t = time.perf_counter()
        self.bench = manifest.Bench(root)
        self.workload, self.seed = workload, seed
        self.cell = self.bench.cell(workload)
        self.cfg = self.bench.config(self.cell["config"])
        self.traffic = self.bench.traffic(self.cell["traffic"])
        self.fam = manifest.family(self.cfg["family"])
        self.cuda = device == "cuda"
        self.marks = _Marks(self.cuda)

    def phase(self, name: str) -> None:
        """Note on standard error how long set-up's part ``name`` took."""
        now = time.perf_counter()
        print(f"perfbench: set-up: {name} {now - self._t:.2f} s",
              file=sys.stderr, flush=True)
        self._t = now

    def setup(self, wrap_optimizer=True) -> "Program":
        import horovod_tpu_torch as hvd
        self.hvd = hvd
        self.phase("import of the program and the family")
        hvd.init() if self.cuda else hvd.init(device="cpu")
        self.phase("init")
        self.rank, self.world = hvd.rank(), hvd.size()
        if self.world != self.traffic["ranks"]:
            raise SystemExit(
                f"perfbench: {self.workload} wants {self.traffic['ranks']} "
                f"ranks, the world has {self.world}")
        self.dev = hvd.device()
        cfg, fam = self.cfg, self.fam
        self.model = fam.build(cfg, self.seed, self.dev)
        _sync(self.cuda)
        self.phase("model and weights")
        hvd.broadcast_parameters(self.model.state_dict(), root_rank=0)
        self.base = fam.optimizer(cfg, self.model)
        self.opt = (hvd.DistributedOptimizer(
            self.base, named_parameters=self.model.named_parameters())
            if wrap_optimizer else self.base)
        self.pool = [fam.batch(cfg, self.traffic, self.seed, self.rank, i,
                               self.dev) for i in range(POOL)]
        _sync(self.cuda)
        self.phase("broadcast, optimizer and batches")
        return self

    def step(self, i: int, after_backward=None):
        """The user's training step on batch ``i`` of the pool."""
        batch = self.pool[i % POOL]
        self.opt.zero_grad()
        with torch.profiler.record_function("perfbench.forward"):
            loss = self.fam.loss(self.model, batch)
        with torch.profiler.record_function("perfbench.backward"):
            loss.backward()
        if after_backward is not None:
            after_backward.append(self.marks.mark())
        with torch.profiler.record_function("perfbench.optimizer_step"):
            self.opt.step()
        return loss.detach()

    def check_steps(self) -> dict:
        """The first ``CHECK_STEPS`` steps, and what the comparison reads
        of them: the world's mean loss of each, each leaf's first gradient
        (from the optimizer's state) and, on rank 0, each leaf's change."""
        out: dict = {"losses": []}
        for i in range(CHECK_STEPS):
            out["losses"].append(self.step(i))
            if i == 0:
                out["grad_norms"] = _first_grad_norms(self.base, self.model,
                                                      self.cfg)
        if self.rank == 0:
            out["change_norms"] = weights.change_norms(
                dict(self.model.named_parameters()),
                self.fam.reference.param_spec(self.cfg), self.seed)
        losses = torch.stack(out["losses"]).float()
        if self.world > 1:
            losses = self.hvd.allreduce(losses, op=self.hvd.Average)
        out["losses"] = losses.tolist()
        self.phase("checked steps")
        return out

    def window(self, seconds: float, trace: bool, t_start: float) -> dict:
        """Warm-up, then the timed window; returns this rank's result."""
        hvd, cuda, marks = self.hvd, self.cuda, self.marks
        self.step(CHECK_STEPS)
        _sync(cuda)
        t0 = time.perf_counter()
        for i in range(CHECK_STEPS + 1, CHECK_STEPS + WARM_STEPS):
            self.step(i)
        _sync(cuda)
        step_s = (time.perf_counter() - t0) / (WARM_STEPS - 1)
        least = PROFILE_AT + PROFILE_STEPS + 2
        # one rank stops at the deadline; ranks in lockstep share a count
        n_steps = (None if self.world == 1 else hvd.broadcast_object(
            max(least, math.ceil(seconds / step_s)), 0))
        self.phase("warm-up")
        profiled = (set(range(PROFILE_AT - 1, PROFILE_AT + PROFILE_STEPS))
                    if trace else set())
        first = CHECK_STEPS + WARM_STEPS
        starts, after_bwd, losses = [], [], []
        prof = None
        hvd.barrier()
        _sync(cuda)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        host = _HostClock()
        window_start_wall = time.time()
        t0 = time.perf_counter()
        i = 0
        while (i < n_steps if n_steps is not None
               else i < least or time.perf_counter() - t0 < seconds):
            if trace and i == PROFILE_AT:
                _sync(cuda)
                prof = _profiler()
                prof.start()
            if trace and i == PROFILE_AT + PROFILE_STEPS:
                _sync(cuda)
                prof.stop()
            starts.append(marks.mark())
            with torch.profiler.record_function("perfbench.step"):
                losses.append(self.step(first + i, after_bwd))
            i += 1
        n_steps = i
        starts.append(marks.mark())
        _sync(cuda)
        window_s = time.perf_counter() - t0
        host_use = host.stop()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        nonfinite = int((~torch.isfinite(torch.stack(losses))).sum().item())
        cfg, traffic, fam = self.cfg, self.traffic, self.fam
        result = {
            "rank": self.rank, "world": self.world,
            "device_name": (torch.cuda.get_device_name(self.dev) if cuda
                            else "cpu"),
            "platform": "gpu" if cuda else "cpu",
            "setup_s": window_start_wall - t_start, "window_s": window_s,
            "steps": n_steps,
            "step_ms": [marks.ms(starts[i], starts[i + 1])
                        for i in range(n_steps)],
            "fwd_bwd_ms": [marks.ms(starts[i], after_bwd[i])
                           for i in range(n_steps)],
            "update_ms": [marks.ms(after_bwd[i], starts[i + 1])
                          for i in range(n_steps)],
            "profiled": sorted(profiled), "peak_bytes": peak,
            "nonfinite": nonfinite, "host": host_use,
            "work": {"unit": fam.UNIT, "items": fam.items(traffic),
                     "flops": fam.flops_per_step(cfg, traffic),
                     "flash": fam.flash_launch(cfg, traffic),
                     "dtype": cfg["compute_dtype"]},
        }
        if prof is not None:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                t1 = time.perf_counter()
                del prof
                size = os.path.getsize(path)
                result["trace"] = trace_mod.load(path)
            print(f"perfbench: rank {self.rank}: trace {size / 2**20:.1f} "
                  f"MiB, exported in {t1 - t0:.1f} s, read in "
                  f"{time.perf_counter() - t1:.1f} s; "
                  f"{len(result['trace']['device'])} device and "
                  f"{len(result['trace']['host'])} host spans",
                  file=sys.stderr, flush=True)
        return result

    def close(self, leave: bool = True) -> None:
        """Free the program's state and, with ``leave``, leave the world."""
        for name in ("model", "opt", "base", "pool"):
            self.__dict__.pop(name, None)
        if leave:
            self.hvd.shutdown()
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference_steps(self) -> list:
        """The checked steps' batches of every rank, drawn again."""
        return [[self.fam.batch(self.cfg, self.traffic, self.seed, r, i,
                                self.dev) for r in range(self.world)]
                for i in range(CHECK_STEPS)]


def run_rank(root, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda") -> dict:
    """One rank's run. Rank 0's result holds the program's and the
    reference's readings."""
    from .reference import train as ref_train
    prog = Program(root, workload, seed, device).setup()
    program = prog.check_steps()
    result = prog.window(seconds, trace, t_start)
    result["forbidden"] = imports.forbidden_loaded()
    prog.close()
    if prog.rank == 0:
        result["program"] = program
        result["reference"] = ref_train.readings(
            prog.fam.reference, prog.cfg, seed, prog.reference_steps(),
            prog.dev)
    return result


def main(argv=None) -> int:
    """A rank under the launcher: writes ``<out>/rank<r>.json``."""
    p = argparse.ArgumentParser(prog="python -m perfbench.worker")
    p.add_argument("--root", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--t-start", type=float, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    res = run_rank(a.root, a.workload, a.seed, a.seconds, bool(a.trace),
                   a.t_start, a.device)
    res["forbidden"] = sorted(set(res["forbidden"])
                              | set(imports.forbidden_loaded()))
    tmp = os.path.join(a.out, f".rank{res['rank']}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(res, f)
    os.replace(tmp, os.path.join(a.out, f"rank{res['rank']}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
