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
import socket
import subprocess
import sys
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
    (y.float() * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()
    return {"y": nhwc(y), "dx": nhwc(xt.grad),
            "dscale": norm.weight.grad.numpy(),
            "dbias": norm.bias.grad.numpy(),
            "mean": norm.running_mean.numpy().copy(),
            "var": norm.running_var.numpy().copy()}


def _sync_bn_rank(out_path: str) -> None:
    """One rank's half of the batch through ``SyncBatchNorm``."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        rank, inp = hvd.rank(), bn_inputs()
        half = BN_SHAPE[0] // hvd.size()
        mine = slice(rank * half, (rank + 1) * half)
        out = {}
        for dtype in BN_DTYPES:
            x = torch.from_numpy(inp["x"][mine]).to(getattr(torch, dtype))
            norm = hvd.SyncBatchNorm(BN_SHAPE[-1], dtype=x.dtype,
                                     device="cpu")
            res = bn_step(norm, x, inp["ct"][mine], inp)
            out.update({f"{dtype}_{k}": v for k, v in res.items()})
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(rank_main: str, tmp: Path, size: int = 2) -> list:
    """Run ``rank_main(out_path)``, a function of this module, in each rank
    of one gloo world of ``size`` processes; returns each rank's saved
    arrays."""
    port = _free_port()
    procs = []
    for rank in range(size):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(size),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO), str(REPO / "tests"),
                        os.environ.get("PYTHONPATH", "")]))
        code = ("import sys, test_torch_world2 as w; "
                f"w.{rank_main}(sys.argv[1])")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(tmp / f"rank{rank}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
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
