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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Results of both ranks, from one world of two processes."""
    tmp = tmp_path_factory.mktemp("world2")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [str(REPO), str(REPO / "tests"),
                        os.environ.get("PYTHONPATH", "")]))
        code = ("import sys, test_torch_world2 as w; "
                f"w._rank_main(sys.argv[1])")
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


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
