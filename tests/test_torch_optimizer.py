"""The port's hook-driven ``DistributedOptimizer``, ``value_and_grad`` and
``grad`` and custom compressors against the JAX package's.

A spawned gloo world of 2 (started once for the module by
:func:`test_torch_world2.run_world`) runs :func:`_optimizer_rank`, which
imports no JAX, and a world of 3 runs :func:`_optimizer_pset_rank`. The
reference runs on two devices of the conftest's 8-device CPU mesh, under
``jax.shard_map`` over a mesh of those two (the optimizer and
``value_and_grad``), or on a JAX process set of them (eager collectives).
Tolerances: the gradient syncs are bitwise (integer-valued inputs or the
same reduction on both sides); Adam through ``backward_passes_per_step``
rtol 1e-5 (torch's and optax's Adam round differently); ``value_and_grad``
rtol 1e-5 (the two frameworks' tanh and matmul).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world

LR = 0.25
SHAPES = {"w": (3, 4), "b": (4,)}
MS_LR = 0.1
MS_KS = (2, 3)


def mlp_params() -> list:
    """The MLP's weights (the same on every rank), float32."""
    rng = np.random.default_rng(7)
    dims = [(6, 16), (16,), (16, 16), (16,), (16, 4), (4,)]
    return [rng.standard_normal(d).astype(np.float32) * 0.5 for d in dims]


def mlp_data(rank: int) -> np.ndarray:
    return np.random.default_rng(40 + rank).standard_normal(
        (5, 6)).astype(np.float32)


def mlp_loss(ps, x):
    h = torch.tanh(x @ ps[0] + ps[1])
    h = torch.tanh(h @ ps[2] + ps[3])
    return ((h @ ps[4] + ps[5]) ** 2).sum()


def ms_params() -> dict:
    rng = np.random.default_rng(3)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def ms_grads(k: int, n: int = 2) -> list:
    """``[pass][rank]`` gradients of the ``backward_passes_per_step=k``
    run: 2k passes."""
    rng = np.random.default_rng(10 + k)
    return [[{name: rng.standard_normal(s).astype(np.float32)
              for name, s in SHAPES.items()} for _ in range(n)]
            for _ in range(2 * k)]


def vg_inputs(rank: int) -> dict:
    rng = np.random.default_rng(60 + rank)
    return {"x": rng.standard_normal((4, 3)).astype(np.float32),
            "w": np.random.default_rng(61).standard_normal(
                (3, 2)).astype(np.float32)}


def compress_inputs(rank: int) -> list:
    rng = np.random.default_rng(70 + rank)
    return [rng.integers(-50, 50, size=s).astype(np.float32)
            for s in ((3, 2), (5,))]


class Halver:
    """A compressor with its own wire format and no ``wire_dtype``: halves
    on the way out, doubles on the way back, and counts its calls."""

    calls = []

    @classmethod
    def compress(cls, t):
        cls.calls.append("c")
        return t * 0.5, "ctx"

    @classmethod
    def decompress(cls, t, ctx):
        assert ctx == "ctx"
        cls.calls.append("d")
        return t * 2.0


def _logged_starts(hvd):
    """Record the shapes of every ``grouped_allreduce_async`` the optimizer
    starts, in issue order."""
    from horovod_tpu_torch.ops import collectives
    log, real = [], collectives.grouped_allreduce_async

    def logged(tensors, **kw):
        log.append([tuple(t.shape) for t in tensors])
        return real(tensors, **kw)

    collectives.grouped_allreduce_async = logged
    return log, lambda: setattr(collectives, "grouped_allreduce_async", real)


def run_multisteps(hvd, k: int, dev) -> dict:
    """Adam through ``backward_passes_per_step=k`` over 2k passes of the
    gradients ``ms_grads(k)`` (loss ``sum(p * g)``): the parameters after
    every pass, and the reduced gradients of each k-th pass."""
    rank = hvd.rank()
    params = {n: torch.nn.Parameter(torch.from_numpy(v).to(dev))
              for n, v in ms_params().items()}
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(params.values(), lr=MS_LR),
        backward_passes_per_step=k)
    out = {}
    for i, grads in enumerate(ms_grads(k, hvd.size())):
        opt.zero_grad()
        sum((params[n] * torch.from_numpy(g).to(dev)).sum()
            for n, g in grads[rank].items()).backward()
        if (i + 1) % k == 0:
            opt.synchronize()
            out.update({f"ms{k}_grad{i}_{n}": p.grad.cpu().numpy().copy()
                        for n, p in params.items()})
        opt.step()
        out.update({f"ms{k}_pass{i}_{n}": p.detach().cpu().numpy().copy()
                    for n, p in params.items()})
    out[f"ms{k}_in_backward"] = np.asarray(opt.stats["started_in_backward"])
    return out


def _optimizer_rank(out_path: str, device: str | None = "cpu") -> None:
    """One rank of the world of 2: every optimizer check, its results
    saved."""
    import horovod_tpu_torch as hvd

    os.environ["HVD_BUCKET_BYTES"] = "600"  # several gradient buckets
    hvd.init(device=device)
    try:
        rank, dev = hvd.rank(), hvd.device()
        out = {}
        # the hook-driven sync against the sync of all gradients at once
        ps = [torch.nn.Parameter(torch.from_numpy(p).to(dev))
              for p in mlp_params()]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=LR))
        log, restore = _logged_starts(hvd)
        opt.zero_grad()
        mlp_loss(ps, torch.from_numpy(mlp_data(rank)).to(dev)).backward()
        in_backward = len(log)
        local = [p.grad.clone() for p in ps]
        opt.synchronize()
        reduced = [p.grad.clone() for p in ps]
        after_sync = len(log)
        opt.step()
        restore()
        want = hvd.grouped_allreduce(local)
        out.update({"in_backward": np.asarray(in_backward),
                    "stats_in_backward": np.asarray(
                        opt.stats["started_in_backward"]),
                    "bucket_bytes": np.asarray(opt.stats["bucket_bytes"]),
                    "starts": np.asarray(after_sync),
                    "starts_after_step": np.asarray(len(log)),
                    "log": repr(log)})
        for i, (r, w, p) in enumerate(zip(reduced, want, ps)):
            out.update({f"reduced{i}": r.cpu().numpy(),
                        f"want{i}": w.cpu().numpy(),
                        f"local{i}": local[i].cpu().numpy(),
                        f"stepped{i}": p.detach().cpu().numpy()})
        # a parameter that only rank 0 uses travels as zeros from rank 1
        u = torch.nn.Parameter(torch.ones(3, device=dev))
        v = torch.nn.Parameter(torch.ones(2, device=dev))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([u, v], lr=LR))
        opt.zero_grad()
        loss = (v * 3.0).sum()
        if rank == 0:
            loss = loss + (u * torch.tensor([2.0, 4.0, 6.0],
                                            device=dev)).sum()
        loss.backward()
        opt.step()
        out.update({"unused_grad": u.grad.cpu().numpy(),
                    "unused_param": u.detach().cpu().numpy(),
                    "used_grad": v.grad.cpu().numpy()})
        for k in MS_KS:
            out.update(run_multisteps(hvd, k, dev))
        # value_and_grad and grad
        inp = {k: torch.from_numpy(v).to(dev)
               for k, v in vg_inputs(rank).items()}
        fun = lambda w, x: (torch.tanh(x @ w) ** 2).sum()
        aux = lambda w, x: (fun(w, x), x.sum())
        value, g = hvd.value_and_grad(fun)(inp["w"], inp["x"])
        (value_a, aux_a), g_a = hvd.value_and_grad(aux, has_aux=True)(
            inp["w"], inp["x"])
        g_only = hvd.grad(fun)(inp["w"], inp["x"])
        g_aux, aux_g = hvd.grad(aux, has_aux=True)(inp["w"], inp["x"])
        g_both = hvd.grad(lambda d, x: fun(d["w"], x), argnums=(0, 1))(
            {"w": inp["w"]}, inp["x"])
        res = {"vg_value": value, "vg_grad": g, "vga_value": value_a,
               "vga_aux": aux_a, "vga_grad": g_a, "g_grad": g_only,
               "ga_grad": g_aux, "ga_aux": aux_g, "gb_w": g_both[0]["w"],
               "gb_x": g_both[1]}
        out.update({k: v.detach().cpu().numpy() for k, v in res.items()})
        # a custom compressor, alone and through the optimizer
        xs = [torch.from_numpy(x).to(dev) for x in compress_inputs(rank)]
        Halver.calls.clear()
        res = hvd.grouped_allreduce(xs, compression=Halver)
        out["halver_calls"] = np.asarray(len(Halver.calls))
        out.update({f"halver{i}": r.cpu().numpy() for i, r in enumerate(res)})
        ps = [torch.nn.Parameter(torch.zeros_like(x)) for x in xs]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=1.0),
                                       compression=Halver)
        opt.zero_grad()
        sum((p * x).sum() for p, x in zip(ps, xs)).backward()
        opt.step()
        out.update({f"halver_opt{i}": p.detach().cpu().numpy()
                    for i, p in enumerate(ps)})
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


def _multisteps_rank_on_card(out_path: str) -> None:
    """One rank of an NCCL world (one card a rank): the
    ``backward_passes_per_step=2`` Adam run of :func:`run_multisteps`."""
    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        np.savez(out_path, **run_multisteps(hvd, 2, hvd.device()))
    finally:
        hvd.shutdown()


OVERLAP_STEPS = 3


def _overlap_rank_on_card(out_path: str) -> None:
    """One rank of a data-parallel trainer over NCCL (one card a rank): the
    full-width TransformerLM, 8 x 2048 tokens a rank, Adam; the mean step
    time of ``OVERLAP_STEPS`` steps after warm-up, and on rank 0 one more
    step under ``torch.profiler`` with whether the gradient buckets' NCCL
    kernels started before the backward pass's last kernel ended."""
    import tempfile
    import time
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import testing
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)

    hvd.init()
    try:
        rank = hvd.rank()
        cfg = TransformerConfig(attn_mode="ulysses")
        model = TransformerLM(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        opt = hvd.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3))
        tokens = torch.from_numpy(np.random.default_rng(rank).integers(
            0, cfg.vocab_size, size=(8, 2048))).to(hvd.device())

        def step():
            opt.zero_grad()
            loss = lm_loss(model(tokens), tokens)
            with torch.profiler.record_function("backward"):
                loss.backward()
            opt.step()
            return loss.item()

        losses = [step() for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step() for _ in range(OVERLAP_STEPS)]
        torch.cuda.synchronize()
        out = {"step_ms": (time.perf_counter() - t0) / OVERLAP_STEPS * 1e3,
               "losses": losses,
               "buckets": len(opt.stats["bucket_bytes"]),
               "started_in_backward": opt.stats["started_in_backward"]}
        if rank == 0:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                out["overlap"] = repr(testing.backward_overlap(path))
        else:
            step()
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


PSET_GRADS = [np.array([2.0, -4.0, 6.0], np.float32) * (r + 1)
              for r in range(3)]


def _optimizer_pset_rank(out_path: str) -> None:
    """One rank of the world of 3: SGD over the process set [0, 1]; rank 2
    steps on its own gradient."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu", process_sets=[[0, 1]])
    try:
        rank = hvd.rank()
        ps = hvd.runtime.process_set_table().find([0, 1])
        p = torch.nn.Parameter(torch.ones(3))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=LR),
                                       process_set=ps)
        opt.zero_grad()
        (p * torch.from_numpy(PSET_GRADS[rank])).sum().backward()
        opt.step()
        np.savez(out_path, param=p.detach().numpy(),
                 started=np.asarray(opt.stats["started_in_backward"]))
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("_optimizer_rank", tmp_path_factory.mktemp("optim2"),
                     size=2, module="test_torch_optimizer")


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return run_world("_optimizer_pset_rank",
                     tmp_path_factory.mktemp("optim3"), size=3,
                     module="test_torch_optimizer")


@pytest.fixture(scope="module")
def mesh2():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:2]), ("hvd",))


def test_hook_sync_equals_step_time_sync(world2):
    """The gradients the hooks' buckets reduce are bitwise those of one
    grouped allreduce of all local gradients at step time; SGD then steps
    once on them."""
    for res in world2:
        for i, p0 in enumerate(mlp_params()):
            np.testing.assert_array_equal(res[f"reduced{i}"], res[f"want{i}"])
            np.testing.assert_array_equal(res[f"stepped{i}"],
                                          p0 - np.float32(LR) * res[
                                              f"want{i}"])
    local = [[res[f"local{i}"] for i in range(6)] for res in world2]
    assert not all(np.array_equal(a, b) for a, b in zip(*local))


def test_buckets_start_in_backward_in_one_order(world2):
    """Several buckets (the last layers' first); at least one started
    before ``backward()`` returned, the rest at ``synchronize()``; both
    ranks issued the same stream of collectives, in bucket order."""
    r0, r1 = world2
    assert len(r0["bucket_bytes"]) >= 3
    assert str(r0["log"]) == str(r1["log"])
    shapes = eval(str(r0["log"]))
    assert shapes == [[(4,), (16, 4), (16,)], [(16, 16)],  # reverse order
                      [(16,), (6, 16)]]
    assert r0["bucket_bytes"].tolist() == [336, 1024, 448]
    for res in world2:
        assert int(res["in_backward"]) >= 1
        assert res["stats_in_backward"].tolist() == [int(res["in_backward"])]


def test_synchronize_then_step_reduces_once(world2):
    for res in world2:
        assert int(res["starts"]) == len(res["bucket_bytes"])
        assert int(res["starts_after_step"]) == int(res["starts"])


def test_unused_parameter_travels_as_zeros(world2):
    """Rank 1 never uses ``u``: its gradient travels as zeros, so both
    ranks average to half of rank 0's and step alike; nothing hangs."""
    want = np.array([2.0, 4.0, 6.0], np.float32) / 2
    for res in world2:
        np.testing.assert_array_equal(res["unused_grad"], want)
        np.testing.assert_array_equal(res["unused_param"],
                                      1 - np.float32(LR) * want)
        np.testing.assert_array_equal(res["used_grad"], [3.0, 3.0])


@pytest.mark.parametrize("k", MS_KS)
def test_backward_passes_per_step_matches_multisteps(hvd, world2, mesh2, k):
    """Adam with ``backward_passes_per_step=k`` against
    ``optax.MultiSteps(DistributedOptimizer(optax.adam))`` on the same
    gradients over 2k passes: unchanged parameters on the passes that
    fold, the same parameters after each k-th (rtol 1e-5)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    tx = optax.MultiSteps(hvd.DistributedOptimizer(optax.adam(MS_LR)),
                          every_k_schedule=k)
    params = {n: jnp.asarray(v) for n, v in ms_params().items()}
    state = tx.init(params)

    def step(p, s, g):
        u, s = tx.update(jax.tree.map(lambda x: x[0], g), s, p)
        return optax.apply_updates(p, u), s

    fn = jax.jit(jax.shard_map(step, mesh=mesh2,
                               in_specs=(P(), P(), P("hvd")),
                               out_specs=(P(), P()), check_vma=False))
    before = ms_params()
    for i, grads in enumerate(ms_grads(k)):
        g = {n: np.stack([grads[r][n] for r in range(2)]) for n in SHAPES}
        params, state = fn(params, state, g)
        for res in world2:
            for n in SHAPES:
                got = res[f"ms{k}_pass{i}_{n}"]
                if (i + 1) % k:
                    np.testing.assert_array_equal(got, before[n])
                else:
                    # atol: optax's float32 bias correction 1 - 0.999**t is
                    # 4.7e-5 off, 2.3e-6 of the lr-0.1 step (optax reads
                    # 1.7e-6 from float64 Adam here, torch 1.9e-7)
                    np.testing.assert_allclose(got, np.asarray(params[n]),
                                               rtol=1e-5, atol=5e-6)
        if (i + 1) % k == 0:
            before = {n: res[f"ms{k}_pass{i}_{n}"] for n in SHAPES}
    for res in world2:
        assert res[f"ms{k}_in_backward"].tolist() == [1, 1]


@pytest.mark.parametrize("k", MS_KS)
def test_backward_passes_per_step_matches_float64_adam(world2, k):
    """The same run against Adam in float64 on the mean of each k passes'
    gradients over both ranks: within 5e-7 (float32 rounding)."""
    grads = ms_grads(k)
    p = {n: v.astype(np.float64) for n, v in ms_params().items()}
    m = {n: np.zeros_like(v) for n, v in p.items()}
    v2 = {n: np.zeros_like(v) for n, v in p.items()}
    for t in (1, 2):
        for n in SHAPES:
            g = np.mean([grads[i][r][n] for i in range((t - 1) * k, t * k)
                         for r in range(2)], axis=0, dtype=np.float64)
            m[n] = 0.9 * m[n] + 0.1 * g
            v2[n] = 0.999 * v2[n] + 0.001 * g * g
            p[n] = p[n] - MS_LR * (m[n] / (1 - 0.9 ** t)) / (
                np.sqrt(v2[n] / (1 - 0.999 ** t)) + 1e-8)
            for res in world2:
                np.testing.assert_allclose(
                    res[f"ms{k}_pass{t * k - 1}_{n}"], p[n], rtol=0,
                    atol=5e-7)


@pytest.mark.parametrize("k", MS_KS)
def test_backward_passes_reduce_the_running_mean(world2, k):
    """The gradient each k-th pass reduces is MultiSteps' running mean of
    the k passes over both ranks (rtol 1e-6: float32 running means)."""
    grads = ms_grads(k)
    for j in range(2):
        last = (j + 1) * k - 1
        for n in SHAPES:
            want = np.mean([grads[i][r][n] for i in range(j * k, last + 1)
                            for r in range(2)], axis=0)
            for res in world2:
                np.testing.assert_allclose(res[f"ms{k}_grad{last}_{n}"],
                                           want, rtol=1e-6, atol=1e-7)


def _jax_vg(hvd, mesh2, has_aux, use_grad=False):
    """The reference's value_and_grad (or grad) of the same function on the
    two ranks' inputs; returns per-rank values and the reduced gradient."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    fun = lambda w, x: jnp.sum(jnp.tanh(x @ w) ** 2)
    aux = lambda w, x: (fun(w, x), jnp.sum(x))
    f = aux if has_aux else fun
    xs = np.stack([vg_inputs(r)["x"] for r in range(2)])
    w = vg_inputs(0)["w"]

    def body(w, x):
        if use_grad:
            out = hvd.grad(f, has_aux=has_aux)(w, x[0])
            return out if not has_aux else (out[0], out[1][None])
        v, g = hvd.value_and_grad(f, has_aux=has_aux)(w, x[0])
        v = (v[0][None], v[1][None]) if has_aux else v[None]
        return v, g

    specs = {(False, False): (P("hvd"), P()),
             (True, False): ((P("hvd"), P("hvd")), P()),
             (False, True): P(), (True, True): (P(), P("hvd"))}
    return jax.jit(jax.shard_map(
        body, mesh=mesh2, in_specs=(P(), P("hvd")),
        out_specs=specs[(has_aux, use_grad)], check_vma=False))(w, xs)


def test_value_and_grad_matches_jax(hvd, world2, mesh2):
    """The value stays this rank's own, the gradient is the average; with
    ``has_aux`` the aux too stays this rank's (rtol 1e-5)."""
    close = lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                    rtol=1e-5, atol=1e-6)
    value, g = _jax_vg(hvd, mesh2, False)
    (value_a, aux_a), g_a = _jax_vg(hvd, mesh2, True)
    for r, res in enumerate(world2):
        close(res["vg_value"], value[r])
        close(res["vg_grad"], g)
        close(res["vga_value"], value_a[r])
        close(res["vga_aux"], aux_a[r])
        close(res["vga_grad"], g_a)


def test_grad_matches_jax(hvd, world2, mesh2):
    """``grad`` gives the gradients, ``grad(has_aux=True)`` ``(grads,
    aux)``; a dict argument's gradient is a dict, and ``argnums=(0, 1)``
    a tuple, each the average over the ranks (rtol 1e-5)."""
    close = lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                    rtol=1e-5, atol=1e-6)
    g = _jax_vg(hvd, mesh2, False, use_grad=True)
    g_a, aux = _jax_vg(hvd, mesh2, True, use_grad=True)
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    fun = lambda d, x: jnp.sum(jnp.tanh(x @ d["w"]) ** 2)
    xs = np.stack([vg_inputs(r)["x"] for r in range(2)])
    gw, gx = jax.jit(jax.shard_map(
        lambda w, x: hvd.grad(fun, argnums=(0, 1))({"w": w}, x[0]),
        mesh=mesh2, in_specs=(P(), P("hvd")), out_specs=P(),
        check_vma=False))(vg_inputs(0)["w"], xs)
    for r, res in enumerate(world2):
        close(res["g_grad"], g)
        close(res["ga_grad"], g_a)
        close(res["ga_aux"], aux[r])
        close(res["gb_w"], gw["w"])
        close(res["gb_x"], gx)


def test_custom_compressor_matches_jax(hvd, world2):
    """A compressor with its own wire format wraps each tensor (compress,
    reduce, decompress), as the reference's per-leaf path does: bitwise on
    integer-valued inputs, directly and through the optimizer."""
    from horovod_tpu.ops.compression import Compression

    class JaxHalver(Compression.none):
        @staticmethod
        def compress(t):
            return t * 0.5, None

        @staticmethod
        def decompress(t, ctx):
            return t * 2.0

    ps = hvd.add_process_set([0, 1])
    try:
        bundles = [hvd.per_rank([compress_inputs(r)[i] for r in range(2)],
                                ps) for i in range(2)]
        want = hvd.grouped_allreduce(bundles, compression=JaxHalver,
                                     process_set=ps)
    finally:
        hvd.remove_process_set(ps)
    for res in world2:
        assert int(res["halver_calls"]) == 4  # two tensors, each both ways
        for i, w in enumerate(want):
            w = np.asarray(w)
            np.testing.assert_array_equal(res[f"halver{i}"], w)
            np.testing.assert_array_equal(res[f"halver_opt{i}"], -w)


def test_optimizer_over_a_process_set(world3):
    """SGD over the set [0, 1] of a world of 3: the members step on their
    average, rank 2 on its own gradient."""
    avg = (PSET_GRADS[0] + PSET_GRADS[1]) / 2
    for r, res in enumerate(world3):
        g = avg if r < 2 else PSET_GRADS[2]
        np.testing.assert_array_equal(res["param"], 1 - np.float32(LR) * g)
        assert res["started"].tolist() == ([1] if r < 2 else [])


def test_optimizer_refuses_bad_settings():
    """``backward_passes_per_step`` below 1, and sparse paths without the
    names to match them against."""
    import horovod_tpu_torch as thvd
    thvd.init(device="cpu")
    try:
        p = torch.nn.Parameter(torch.ones(2, 2))
        with pytest.raises(ValueError, match="backward_passes_per_step"):
            thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                      backward_passes_per_step=0)
        with pytest.raises(ValueError, match="named_parameters"):
            thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                      sparse_gradient_paths=["x"],
                                      sparse_max_rows=2)
    finally:
        thvd.shutdown()


def test_second_backward_before_step_raises():
    """Two backward passes before ``step()`` at ``backward_passes_per_step``
    1 would reduce a half-accumulated gradient: the hook refuses, with the
    reference Horovod's advice."""
    import horovod_tpu_torch as thvd
    thvd.init(device="cpu")
    try:
        p = torch.nn.Parameter(torch.ones(2))
        opt = thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0))
        (p * 2).sum().backward()
        with pytest.raises(RuntimeError, match="backward_passes_per_step"):
            (p * 2).sum().backward()
    finally:
        thvd.shutdown()
