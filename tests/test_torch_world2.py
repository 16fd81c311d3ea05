"""The port's collectives across a real world of two processes (gloo, CPU).

One world of two ranks is started once for the module, on a free local port,
each rank a subprocess with ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/
``MASTER_PORT`` set as a launcher sets them. Every check stays in the
exactness domain (integer-valued float32, divisor 2), so the expected values
are exact and every comparison is bitwise:

* ``grouped_allreduce`` (AVERAGE) with ``Compression.none`` and ``fp16``,
  over several fusion buckets;
* ``broadcast_parameters`` of a ``state_dict``;
* one ``DistributedOptimizer(SGD)`` step over several gradient buckets.

The file imports nothing of JAX: a rank imports it to run :func:`_rank_main`.
It also holds the rank side of the world-2 parity tests whose reference
side needs JAX (``test_torch_sync_bn.py``, ``test_torch_training_utils.py``):
:func:`run_world` runs one of its ``_*_rank`` functions in every rank.
"""

import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(3, 5), (7,), (2, 2, 2), (33,), (1,)]
LR = 0.5
TIMEOUT_S = 180


def _inputs(rank: int) -> dict:
    """Rank ``rank``'s inputs: integer-valued float32, from its own seed."""
    rng = np.random.default_rng(100 + rank)
    ints = lambda shape: rng.integers(-60, 60, size=shape).astype(np.float32)
    return {"xs": [ints(s) for s in SHAPES],
            "params": [ints(s) for s in SHAPES],
            "grads": [ints(s) for s in SHAPES]}


def _rank_main(out_path: str) -> None:
    """One rank of the world: run every check, save the results."""
    import horovod_tpu_torch as hvd

    os.environ["HVD_FUSION_THRESHOLD"] = "64"  # several wire buffers
    os.environ["HVD_BUCKET_BYTES"] = "100"     # several gradient buckets
    hvd.init(device="cpu")
    try:
        rank = hvd.rank()
        inp = _inputs(rank)
        out = {}
        for name in ("none", "fp16"):
            res = hvd.grouped_allreduce(
                [torch.from_numpy(x) for x in inp["xs"]],
                compression=getattr(hvd.Compression, name))
            out.update({f"{name}_{i}": r.numpy() for i, r in enumerate(res)})
        sd = {f"p{i}": torch.from_numpy(p.copy())
              for i, p in enumerate(inp["params"])}
        hvd.broadcast_parameters(sd, root_rank=0)
        out.update({f"bcast_{k}": v.numpy() for k, v in sd.items()})
        # every rank starts SGD from rank 0's parameters
        params = [torch.nn.Parameter(torch.from_numpy(p))
                  for p in _inputs(0)["params"]]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=LR))
        for p, g in zip(params, inp["grads"]):
            p.grad = torch.from_numpy(g)
        opt.step()
        out.update({f"sgd_{i}": p.detach().numpy()
                    for i, p in enumerate(params)})
        out["size"] = np.asarray(hvd.size())
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


# SyncBatchNorm at world 2: a global NHWC batch of 8 whose halves go to the
# two ranks, with the cotangent of the output and the norm's state.
BN_SHAPE = (8, 3, 5, 6)
BN_DTYPES = ("float32", "bfloat16")


def bn_inputs() -> dict:
    rng = np.random.default_rng(7)
    c = BN_SHAPE[-1]
    f32 = lambda a: np.asarray(a, np.float32)
    return {"x": f32(rng.standard_normal(BN_SHAPE) * 2 + 0.5),
            "ct": f32(rng.standard_normal(BN_SHAPE)),
            "scale": f32(1 + 0.1 * rng.standard_normal(c)),
            "bias": f32(0.1 * rng.standard_normal(c)),
            "mean": f32(0.1 * rng.standard_normal(c)),
            "var": f32(1 + 0.1 * np.abs(rng.standard_normal(c)))}


def bn_step(norm, x, ct, inp) -> dict:
    """One training-mode pass of ``norm`` from ``inp``'s state on NHWC
    numpy ``x`` (cast to ``x``'s dtype name) with cotangent ``ct``: the
    output, dx, dscale, dbias and the updated running averages, NHWC and
    float32."""
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(inp["scale"]))
        norm.bias.copy_(torch.from_numpy(inp["bias"]))
        norm.running_mean.copy_(torch.from_numpy(inp["mean"]))
        norm.running_var.copy_(torch.from_numpy(inp["var"]))
    norm.train()
    xt = x.permute(0, 3, 1, 2).detach().requires_grad_()
    y = norm(xt)
    (y.float() * torch.from_numpy(ct).to(y.device).permute(0, 3, 1, 2)
     ).sum().backward()
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).cpu().numpy()
    host = lambda t: t.detach().cpu().numpy().copy()
    return {"y": nhwc(y), "dx": nhwc(xt.grad),
            "dscale": host(norm.weight.grad), "dbias": host(norm.bias.grad),
            "mean": host(norm.running_mean), "var": host(norm.running_var)}


def _sync_bn_rank(out_path: str, device: str | None = "cpu") -> None:
    """One rank's share of the batch through ``SyncBatchNorm``, on
    ``device`` (gloo on the CPU; None: NCCL, one card a rank)."""
    import horovod_tpu_torch as hvd

    hvd.init(device=device)
    try:
        rank, inp = hvd.rank(), bn_inputs()
        half = BN_SHAPE[0] // hvd.size()
        mine = slice(rank * half, (rank + 1) * half)
        out = {}
        for dtype in BN_DTYPES:
            x = torch.from_numpy(inp["x"][mine]).to(hvd.device(),
                                                    getattr(torch, dtype))
            norm = hvd.SyncBatchNorm(BN_SHAPE[-1], dtype=x.dtype,
                                     device=hvd.device())
            res = bn_step(norm, x, inp["ct"][mine], inp)
            out.update({f"{dtype}_{k}": v for k, v in res.items()})
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


def _sync_bn_rank_on_card(out_path: str) -> None:
    _sync_bn_rank(out_path, device=None)


# ShardedArrayLoader: 56 rows, global batches of 16 (the trailing 8 rows
# divide by 1, 2 and the reference's 8 devices), three epochs.
LOADER_ROWS, LOADER_BATCH, LOADER_EPOCHS = 56, 16, 3


def loader_arrays():
    x = np.arange(LOADER_ROWS * 3, dtype=np.float32).reshape(LOADER_ROWS, 3)
    return x, np.arange(LOADER_ROWS) * 10


def loader_shards() -> dict:
    """This rank's shards of every epoch, with and without the trailing
    partial batch, keyed ``{drop}_e{epoch}_b{batch}_{x|y}``."""
    from horovod_tpu_torch.data import ShardedArrayLoader

    out = {}
    for drop in (True, False):
        loader = ShardedArrayLoader(*loader_arrays(), batch_size=LOADER_BATCH,
                                    seed=5, drop_remainder=drop, device="cpu")
        for epoch in range(LOADER_EPOCHS):
            loader.set_epoch(epoch)
            for i, (x, y) in enumerate(loader):
                out[f"{drop}_e{epoch}_b{i}_x"] = x.numpy()
                out[f"{drop}_e{epoch}_b{i}_y"] = y.numpy()
    return out


def _training_utils_rank(out_path: str) -> None:
    """This rank's loader shards and ``average_metrics`` of rank-dependent
    metrics."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        rank = hvd.rank()
        out = loader_shards()
        logs = hvd.average_metrics({"loss": 1.0 + rank,
                                    "accuracy": 0.25 * (rank + 1)})
        out.update({f"metric_{k}": np.asarray(v) for k, v in logs.items()})
        out["metric_keys"] = np.asarray(list(logs))
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


# The eager collectives at worlds 2 and 4: integer-valued inputs (float32
# and int32), so that every sum is exact and an average divides by a power
# of two; rank r's rows of the ragged allgather are AG_ROWS[r].
AG_ROWS = (2, 0, 3, 1)
A2AV_ROWS = 5


def a2av_splits(n: int) -> np.ndarray:
    """The uneven alltoall's (n, n) splits: row r is what rank r sends
    each rank; every row sums to less than ``A2AV_ROWS`` or to it."""
    i, j = np.indices((n, n))
    return (i + 2 * j) % 3


def collective_inputs(n: int) -> dict:
    """Every rank's inputs of the collectives, as per-rank lists."""
    rng = np.random.default_rng(30 + n)
    ints = lambda shape, dt=np.float32: rng.integers(
        -50, 50, size=shape).astype(dt)
    return {"ag": [ints((AG_ROWS[r], 3)) for r in range(n)],
            "ag_int": [ints((AG_ROWS[r], 2), np.int32) for r in range(n)],
            "ag_scalar": [np.float32(r + 1) for r in range(n)],
            "a2a": [ints((2 * n, 3)) for _ in range(n)],
            "a2a_int": [ints((n, 2), np.int32) for _ in range(n)],
            "a2av": [ints((A2AV_ROWS, 2)) for _ in range(n)],
            "rs": [ints((2 * n, 3)) for _ in range(n)],
            "rs_int": [ints((n, 2), np.int32) for _ in range(n)],
            "bad_rows": [ints((2 * n + 1, 2)) for _ in range(n)],
            "bad_int": [ints((n, 2), np.int32) for _ in range(n)],
            "red": [ints((3, 2)) for _ in range(n)],
            "red_int": [ints((3, 2), np.int32) for _ in range(n)],
            "red_small": [rng.integers(-4, 5, size=(3, 2)).astype(np.float32)
                          for _ in range(n)],
            "red_small_int": [rng.integers(-4, 5, size=(3, 2)).astype(
                np.int32) for _ in range(n)],
            "red_bool": [rng.integers(0, 2, size=(2 * n,)).astype(bool)
                         for _ in range(n)]}


# The allreduce cases beyond AVERAGE of floats, each (input, op, keywords):
# the scale factors (an integer input comes back float32), MIN, MAX,
# PRODUCT (of inputs in [-4, 4], exact over four ranks), and bools (SUM and
# PRODUCT count in int32, MIN and MAX stay bool, AVERAGE is a float32
# share). Every result is exact.
ALLREDUCE_CASES = {
    "ar_pre_int": ("red_int", "Sum", {"prescale_factor": 2.0}),
    "ar_post_int": ("red_int", "Sum", {"postscale_factor": 0.5}),
    "ar_scaled": ("red", "Average", {"prescale_factor": 0.5,
                                     "postscale_factor": 4.0}),
    "ar_max_pre_int": ("red_int", "Max", {"prescale_factor": 2.0}),
    "ar_min": ("red", "Min", {}),
    "ar_max": ("red", "Max", {}),
    "ar_min_int": ("red_int", "Min", {}),
    "ar_max_int": ("red_int", "Max", {}),
    "ar_prod": ("red_small", "Product", {}),
    "ar_prod_int": ("red_small_int", "Product", {}),
    "ar_bool_sum": ("red_bool", "Sum", {}),
    "ar_bool_min": ("red_bool", "Min", {}),
    "ar_bool_max": ("red_bool", "Max", {}),
    "ar_bool_prod": ("red_bool", "Product", {}),
    "ar_bool_avg": ("red_bool", "Average", {}),
}


def collective_objects(rank: int):
    """The objects rank ``rank`` broadcasts and gathers."""
    return {"from": rank, "rows": [rank] * 3}, (rank, "x" * rank)


def _raised(fn) -> str:
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _collectives_rank(out_path: str, device: str | None = "cpu") -> None:
    """One rank of the collectives world: every op on its own inputs, on
    ``device`` (gloo on the CPU; None: NCCL, one card a rank)."""
    import horovod_tpu_torch as hvd

    hvd.init(device=device)
    try:
        n, rank = hvd.size(), hvd.rank()
        inp = {k: torch.as_tensor(v[rank]).to(hvd.device()) for k, v in
               collective_inputs(n).items()}
        if rank > 0:  # rank 0's handle stays open until the others come
            time.sleep(1.0)
        handle = hvd.allreduce_async(inp["red"], op=hvd.Sum)
        polls = [hvd.poll(handle)]
        polled = hvd.synchronize(handle)
        polls.append(handle.poll())
        out = {"polled": polled,
               "ag": hvd.allgather(inp["ag"]),
               "ag_int": hvd.allgather(inp["ag_int"]),
               "ag_scalar": hvd.allgather(inp["ag_scalar"]),
               "ag_async": hvd.allgather_async(inp["ag"]).synchronize(),
               "a2a": hvd.alltoall(inp["a2a"]),
               "a2a_int": hvd.alltoall(inp["a2a_int"]),
               "rs_sum": hvd.reducescatter(inp["rs"], op=hvd.Sum),
               "rs_avg": hvd.reducescatter(inp["rs"], op=hvd.Average),
               "rs_int": hvd.reducescatter(inp["rs_int"]),
               "bcast_async": hvd.broadcast_async(
                   inp["a2a"], root_rank=n - 1).synchronize()}
        out["a2av"], out["a2av_recv"] = hvd.alltoall(
            inp["a2av"], splits=a2av_splits(n)[rank])
        for key, (src, op, kw) in ALLREDUCE_CASES.items():
            out[key] = hvd.allreduce(inp[src], op=getattr(hvd, op), **kw)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        out["polls"] = np.asarray(polls)
        too_many = np.full(n, A2AV_ROWS)
        out.update({
            "err_a2a_rows": _raised(lambda: hvd.alltoall(inp["bad_rows"])),
            "err_rs_rows": _raised(lambda: hvd.reducescatter(
                inp["bad_rows"])),
            "err_rs_avg_int": _raised(lambda: hvd.reducescatter(
                inp["bad_int"], op=hvd.Average)),
            "err_a2av_sum": _raised(lambda: hvd.alltoall(
                inp["a2av"], splits=too_many)),
            "err_a2av_len": _raised(lambda: hvd.alltoall(
                inp["a2av"], splits=too_many[1:])),
            "err_rs_bool": _raised(lambda: hvd.reducescatter(
                inp["red_bool"]))})
        bobj, gobj = collective_objects(rank)
        out["bcast_object"] = repr(hvd.broadcast_object(bobj, n - 1))
        out["gather_object"] = repr(hvd.allgather_object(gobj))
        out["homogeneous"] = hvd.is_homogeneous()
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


def _collectives_rank_on_card(out_path: str) -> None:
    _collectives_rank(out_path, device=None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(argv_of, size: int) -> list:
    """Run the command ``argv_of(rank)`` in each rank of one world of
    ``size`` processes, with the environment a launcher sets (a free local
    port, ``LOCAL_RANK`` = rank); returns each rank's output, after
    checking that every rank exited 0. A rank still running after
    ``TIMEOUT_S`` is aborted, and the failure shows where every thread of
    it was (``PYTHONFAULTHANDLER``)."""
    port = _free_port()
    procs = []
    for rank in range(size):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(size),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONFAULTHANDLER="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO), str(REPO / "tests"),
                        os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            argv_of(rank), env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, hung = [], False
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                hung = True
                for q in procs:
                    if q.poll() is None:
                        q.send_signal(signal.SIGABRT)  # stacks, then exit
                logs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert not hung and p.returncode == 0, (
            f"rank {rank} {'hung' if hung else 'failed'}:\n{log}\n"
            + "\n".join(f"--- rank {r}:\n{other[-4000:]}"
                        for r, other in enumerate(logs) if r != rank))
    return logs


def run_world(rank_main: str, tmp: Path, size: int = 2,
              module: str = "test_torch_world2") -> list:
    """Run ``rank_main(out_path)``, a function of the JAX-free test module
    ``module``, in each rank of one world of ``size`` processes (gloo, or
    NCCL where ``rank_main`` starts one); returns each rank's saved
    arrays."""
    code = f"import sys, {module} as w; w.{rank_main}(sys.argv[1])"
    spawn_world(lambda rank: [sys.executable, "-c", code,
                              str(tmp / f"rank{rank}.npz")], size)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(size)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Results of both ranks, from one world of two processes."""
    return run_world("_rank_main", tmp_path_factory.mktemp("world2"))


@pytest.mark.parametrize("compression", ["none", "fp16"])
def test_grouped_allreduce_average_is_exact(world2, compression):
    x0, x1 = _inputs(0)["xs"], _inputs(1)["xs"]
    for res in world2:
        assert int(res["size"]) == 2
        for i, (a, b) in enumerate(zip(x0, x1)):
            got = res[f"{compression}_{i}"]
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, (a + b) / 2)


def test_broadcast_parameters_is_exact(world2):
    for res in world2:
        for i, p in enumerate(_inputs(0)["params"]):
            np.testing.assert_array_equal(res[f"bcast_p{i}"], p)


def test_distributed_sgd_step_is_exact(world2):
    p0 = _inputs(0)["params"]
    g0, g1 = _inputs(0)["grads"], _inputs(1)["grads"]
    for res in world2:
        for i in range(len(SHAPES)):
            np.testing.assert_array_equal(res[f"sgd_{i}"],
                                          p0[i] - LR * (g0[i] + g1[i]) / 2)
