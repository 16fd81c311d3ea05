"""Adasum of the PyTorch port (``ops/adasum.py``) against the JAX package's.

The port side runs in spawned gloo worlds of 2, 3 and 4 ranks (one per
size, started once for the module), each rank :func:`_adasum_rank` of this
file, which imports no JAX; the world of 4 is two nodes of two
(``LOCAL_WORLD_SIZE=2``) for the two-level variant and the composed sync.
The reference side runs in this process: ``adasum_allreduce`` over a process
set of the conftest's 8 CPU devices, ``adasum_hierarchical_traced`` and
``parallel.sync_gradients`` under ``jax.shard_map`` over a 2 x 2 mesh, and
``DistributedOptimizer(op=Adasum)`` under ``jax.shard_map`` over 2 devices.
The independent numpy model of ``tests/test_adasum.py`` (float64) is the
third party.

Tolerance: rtol 1e-5, atol 1e-6 on float32 (the order of the dot sums
differs and Adasum divides, so no case is bitwise); bf16 results are held
to one bf16 unit in the last place (2**-7 relative), since both sides round
their float32 result to bf16 once. The trainer's losses and parameters
after three SGD steps: rtol 1e-5 and rtol 1e-4 atol 1e-6, as
``tests/test_torch_model.py`` holds its gradients.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world

TOL = dict(rtol=1e-5, atol=1e-6)
LEN = 37
GROUP_SHAPES = [(5,), (3, 4), (7,)]
SYNC_SHAPES = {"w": (3, 5), "b": (7,)}
PSET = [0, 1, 2]
MODEL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
             max_seq_len=32)
LR, STEPS = 0.5, 3


def vec(rank: int, seed: int = 500, n: int = LEN) -> np.ndarray:
    return np.random.default_rng(seed + rank).standard_normal(n).astype(
        np.float32)


def orth(rank: int, n: int) -> np.ndarray:
    v = np.zeros(n * 3, np.float32)
    v[rank * 3:(rank + 1) * 3] = rank + 1.0
    return v


def group_inputs(rank: int) -> list:
    rng = np.random.default_rng(600 + rank)
    return [rng.standard_normal(s).astype(np.float32) for s in GROUP_SHAPES]


def sync_inputs(rank: int) -> dict:
    rng = np.random.default_rng(700 + rank)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SYNC_SHAPES.items()}


def model_tokens(rank: int) -> np.ndarray:
    return np.random.default_rng(800 + rank).integers(
        0, MODEL["vocab_size"], (2, MODEL["max_seq_len"]))


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _adasum_rank(out_path: str) -> None:
    """One rank: every Adasum case of this world's size."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          from_flax_params, lm_loss)
    from horovod_tpu_torch.parallel import mesh as composed

    n = int(os.environ["WORLD_SIZE"])
    hvd.init(device="cpu", process_sets=[PSET] if n == 4 else None)
    try:
        r = hvd.rank()
        t = torch.from_numpy
        ada = lambda x, **kw: hvd.allreduce(x, op=hvd.Adasum, **kw)  # noqa
        out = {"flat": hvd.adasum_allreduce(t(vec(r))).numpy(),
               "ident": ada(torch.linspace(-1, 1, 23)).numpy(),
               "orth": ada(t(orth(r, n))).numpy(),
               "zero": ada(torch.zeros(LEN) if r == 0 else t(vec(r))).numpy(),
               "allzero": ada(torch.zeros(LEN)).numpy(),
               "bf16": ada(t(vec(r)).bfloat16()).float().numpy(),
               "scaled": ada(t(vec(r)), prescale_factor=3.0,
                             postscale_factor=0.5,
                             compression=hvd.Compression.fp16).numpy()}
        xs = [t(x) for x in group_inputs(r)]
        for i, (g, s) in enumerate(zip(
                hvd.grouped_allreduce(xs, op=hvd.Adasum),
                [ada(x) for x in xs])):
            out[f"grp{i}"], out[f"sep{i}"] = g.numpy(), s.numpy()
        p = torch.nn.Parameter(torch.ones(3))
        out["opt_raises"] = _raises(lambda: hvd.DistributedOptimizer(
            torch.optim.SGD([p], lr=1.0), op=hvd.Adasum,
            prescale_factor=2.0))
        out["mesh_raises"] = _raises(lambda: composed.sync_gradients(
            torch.ones(3), op=hvd.Adasum, postscale_factor=2.0))
        if n == 4:
            ps = hvd.runtime.process_set_table().find(PSET)
            if r in PSET:
                out["pset"] = hvd.adasum_allreduce(
                    t(vec(r)), process_set=ps).numpy()
            os.environ["HVD_HIERARCHICAL_ALLREDUCE"] = "1"
            out["two"] = hvd.adasum_allreduce(t(vec(r))).numpy()
            del os.environ["HVD_HIERARCHICAL_ALLREDUCE"]
            synced = composed.sync_gradients(
                {k: t(v) for k, v in sync_inputs(r).items()},
                op=hvd.Adasum)
            out.update({f"sync_{k}": v.numpy() for k, v in synced.items()})
        if n == 2:
            # the trainer: several buckets, SGD, from the JAX weights
            os.environ["HVD_BUCKET_BYTES"] = "65536"
            params = _unflat(dict(np.load(Path(out_path).parent /
                                          "jax_params.npz")))
            model = TransformerLM(TransformerConfig(dtype=torch.float32,
                                                    **MODEL), device="cpu")
            model.load_state_dict(from_flax_params(params))
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=LR), op=hvd.Adasum)
            tokens = torch.from_numpy(model_tokens(r))
            losses = []
            for _ in range(STEPS):
                opt.zero_grad()
                loss = lm_loss(model(tokens), tokens)
                loss.backward()
                opt.step()
                losses.append(loss.item())
            out["losses"] = np.asarray(losses)
            out["in_backward"] = np.asarray(opt.stats["started_in_backward"])
            out["n_buckets"] = len(opt.stats["bucket_bytes"])
            out.update({f"param/{k}": v.numpy()
                        for k, v in model.state_dict().items()})
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()


def _flat_params(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v, np.float32)
    return out


def _jax_trainer(tmp):
    """The reference's ``DistributedOptimizer(optax.sgd, op=Adasum)`` under
    ``jax.shard_map`` over 2 devices: its weights saved for the ranks, each
    device's losses, and the weights after ``STEPS`` steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P
    import horovod_tpu as jhvd
    from horovod_tpu.models import TransformerConfig, TransformerLM
    model = TransformerLM(TransformerConfig(dtype=jnp.float32, **MODEL))
    tokens = np.concatenate([model_tokens(r) for r in range(2)])
    params = model.init(jax.random.PRNGKey(3),
                        jnp.asarray(tokens[:2]))["params"]
    np.savez(tmp / "jax_params.npz", **_flat_params(params))
    tx = jhvd.DistributedOptimizer(optax.sgd(LR), op=jhvd.Adasum)

    def loss_fn(p, t):
        logits = model.apply({"params": p}, t)
        tgt = jnp.roll(t, -1, axis=1)
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), tgt[..., None], -1)[:, :-1])

    def step(p, o, t):
        loss, g = jax.value_and_grad(loss_fn)(p, t)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss[None]

    mesh = Mesh(np.array(jax.devices()[:2]), (jhvd.axis_name(),))
    spec = P(jhvd.axis_name())
    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P(), spec),
                               out_specs=(P(), P(), spec), check_vma=False))
    opt = tx.init(params)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = fn(params, opt, jnp.asarray(tokens))
        losses.append(np.asarray(loss))
    return {"losses": np.stack(losses, 1), "params": params}


@pytest.fixture(scope="module", params=[2, 3, 4],
                ids=["world2", "world3", "world4"])
def world(request, tmp_path_factory):
    """The port's ranks at a world of ``n`` (the world of 4 in two nodes of
    two), and at 2 the reference's trainer run."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"adasum{n}")
    ref = _jax_trainer(tmp) if n == 2 else None
    env = {"LOCAL_WORLD_SIZE": "2"} if n == 4 else None
    return n, run_world("_adasum_rank", tmp, size=n,
                        module="test_torch_adasum", env=env), ref


def np_combine(a, b):
    dot, na, nb = float(a @ b), float(a @ a), float(b @ b)
    ac = 1.0 - dot / (2 * na) if na > 0 else 1.0
    bc = 1.0 - dot / (2 * nb) if nb > 0 else 1.0
    return ac * a + bc * b


def np_adasum(vectors):
    """The independent float64 model of ``tests/test_adasum.py``: the
    non-power-of-two tail folded into the head, then the XOR tree."""
    n = len(vectors)
    p = 1
    while (p << 1) <= n:
        p <<= 1
    vecs = [v.astype(np.float64) for v in vectors]
    for i in range(n - p):
        vecs[i] = np_combine(vecs[i], vecs[p + i])
    vecs = vecs[:p]
    level = 1
    while level < p:
        new = list(vecs)
        for i in range(p):
            j = i ^ level
            a, b = (vecs[i], vecs[j]) if i < j else (vecs[j], vecs[i])
            new[i] = np_combine(a, b)
        vecs = new
        level <<= 1
    return vecs[0]


def _jax_adasum(hvd, vectors, dtype=None):
    """The reference's eager ``adasum_allreduce`` over a process set of the
    first ``len(vectors)`` devices."""
    import jax.numpy as jnp
    from horovod_tpu.ops.adasum import adasum_allreduce
    ps = hvd.add_process_set(list(range(len(vectors))))
    try:
        x = hvd.per_rank([jnp.asarray(v, dtype or jnp.float32)
                          for v in vectors], process_set=ps)
        return np.asarray(adasum_allreduce(x, process_set=ps).astype(
            jnp.float32))
    finally:
        hvd.remove_process_set(ps)


def test_adasum_matches_jax_and_numpy(hvd, world):
    """``adasum_allreduce`` at worlds 2, 3 (the fold of the tail) and 4:
    every rank gets the reference's result and the numpy model's."""
    n, res, _ = world
    vecs = [vec(r) for r in range(n)]
    want = _jax_adasum(hvd, vecs)
    np.testing.assert_allclose(want, np_adasum(vecs), **TOL)
    for got in res:
        np.testing.assert_allclose(got["flat"], want, **TOL)
        np.testing.assert_allclose(got["flat"], np_adasum(vecs), **TOL)


def test_adasum_invariants(world):
    """Identical vectors stay fixed, orthogonal vectors sum, and a vector
    of norm 0 takes coefficient 1 (the zero-norm guard): no NaN."""
    n, res, _ = world
    for got in res:
        np.testing.assert_allclose(
            got["ident"], np.linspace(-1, 1, 23, dtype=np.float32), **TOL)
        np.testing.assert_allclose(
            got["orth"], np.sum([orth(r, n) for r in range(n)], 0), **TOL)
        zero = [np.zeros(LEN, np.float32)] + [vec(r) for r in range(1, n)]
        np.testing.assert_allclose(got["zero"], np_adasum(zero), **TOL)
        np.testing.assert_array_equal(got["allzero"], np.zeros(LEN))


def test_adasum_bf16_accumulates_in_float32(hvd, world):
    """bf16 inputs: the statistics and the combine run in float32, the
    result is rounded to bf16 once, as the reference does it."""
    import jax.numpy as jnp
    n, res, _ = world
    vecs = [vec(r) for r in range(n)]
    want = _jax_adasum(hvd, vecs, jnp.bfloat16)
    rounded = [np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
               for v in vecs]
    for got in res:
        np.testing.assert_allclose(got["bf16"], want, rtol=2 ** -7, atol=0)
        np.testing.assert_allclose(got["bf16"], np_adasum(rounded),
                                   rtol=2 ** -7, atol=1e-6)


def test_grouped_adasum_has_per_tensor_coefficients(world):
    """A ``grouped_allreduce`` of three tensors, fused into one buffer,
    equals three separate calls: one set of coefficients per tensor."""
    n, res, _ = world
    for got in res:
        for i in range(len(GROUP_SHAPES)):
            np.testing.assert_allclose(got[f"grp{i}"], got[f"sep{i}"], **TOL)
            np.testing.assert_allclose(
                got[f"grp{i}"].reshape(-1),
                np_adasum([group_inputs(r)[i].reshape(-1) for r in range(n)]),
                **TOL)


def test_eager_adasum_ignores_scales_and_compression(world):
    """As in the reference, whose eager Adasum returns before the scales
    and the compressor: a scaled, fp16-compressed Adasum is bitwise the
    plain one. The optimizer and the composed sync raise instead."""
    _, res, _ = world
    for got in res:
        np.testing.assert_array_equal(got["scaled"], got["flat"])
        assert "scale-invariant" in str(got["opt_raises"])
        assert "scale-invariant" in str(got["mesh_raises"])


def test_adasum_over_a_process_set(hvd, world):
    """A process set of 3 in a world of 4: its members get the Adasum of
    their three vectors (the fold at 3)."""
    n, res, _ = world
    if n != 4:
        pytest.skip("the world of 4 holds the set")
    want = _jax_adasum(hvd, [vec(r) for r in PSET])
    for r in PSET:
        np.testing.assert_allclose(res[r]["pset"], want, **TOL)
    assert "pset" not in res[3]


def _two_by_two(fn, inputs, axes=("dcn", "ici")):
    """``fn`` of one rank's tree under ``jax.shard_map`` over 4 devices laid
    out (2, 2) along ``axes`` in rank order."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), axes)
    spec = P(axes)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *inputs)
    out = jax.jit(jax.shard_map(
        lambda t: jax.tree.map(lambda x: x[None], fn(
            jax.tree.map(lambda x: x[0], t))),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))(stacked)
    return jax.tree.map(np.asarray, out)


def test_two_level_adasum_matches_jax(world):
    """``HVD_HIERARCHICAL_ALLREDUCE`` over two nodes of two: the node's SUM,
    Adasum across the nodes with the statistics summed over the node, the
    node's allgather; against ``adasum_hierarchical_traced`` on a 2 x 2
    mesh."""
    from horovod_tpu.ops.adasum import adasum_hierarchical_traced
    n, res, _ = world
    if n != 4:
        pytest.skip("needs the world of two nodes of two")
    want = _two_by_two(lambda x: adasum_hierarchical_traced(x, "ici", "dcn"),
                       [vec(r) for r in range(4)])
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["two"], want[r], **TOL)


def test_sync_gradients_adasum_matches_jax(world):
    """``parallel.mesh.sync_gradients(op=ADASUM)`` over dcn 2 x ici_dp 2
    against the reference's under ``jax.shard_map``: per tensor, the
    ``ici_dp`` sum, Adasum across ``dcn``."""
    from horovod_tpu import parallel
    from horovod_tpu.ops.reduce_ops import ReduceOp
    n, res, _ = world
    if n != 4:
        pytest.skip("needs the world of two nodes of two")
    lay = parallel.layout((), ici_size=2, world=4)
    want = _two_by_two(lambda t: parallel.sync_gradients(
        t, lay, op=ReduceOp.ADASUM), [sync_inputs(r) for r in range(4)],
        lay.axis_names)
    for r, got in enumerate(res):
        for k in SYNC_SHAPES:
            np.testing.assert_allclose(got[f"sync_{k}"], want[k][r], **TOL)


def test_optimizer_adasum_trains_as_jax(world):
    """``DistributedOptimizer(SGD, op=Adasum)`` on a 2-layer TransformerLM
    (d_model 64) at world 2, from the reference's weights: three steps'
    losses and the parameters after them equal the reference
    ``DistributedOptimizer(optax.sgd, op=Adasum)``'s; the buckets start in
    the backward pass."""
    from horovod_tpu_torch.models import from_flax_params
    n, res, ref = world
    if n != 2:
        pytest.skip("the trainer runs at world 2")
    want = {k: v.numpy() for k, v in from_flax_params(
        _unflat({k: np.asarray(v) for k, v in _flat_params(
            ref["params"]).items()})).items()}
    for r, got in enumerate(res):
        assert int(got["n_buckets"]) > 1
        assert got["in_backward"].tolist() == [int(got["n_buckets"])] * STEPS
        np.testing.assert_allclose(got["losses"], ref["losses"][r],
                                   rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(got[f"param/{k}"], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


# --------------------------------------------------------------------------
# the rank sides of the four-card tests (tests/test_torch_cuda.py)
# --------------------------------------------------------------------------

CARD_LEN = 1 << 20  # elements of each rank's vector on the card
CARD_STEPS = 5  # trainer steps a run: 2 warm-up, 3 timed


def _adasum_rank_on_card(out_path: str) -> None:
    """One rank over NCCL: Adasum of a 2**20-element float32 vector, flat,
    and two-level where the world is two nodes of two."""
    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        x = torch.from_numpy(vec(hvd.rank(), n=CARD_LEN)).to(hvd.device())
        out = {"flat": hvd.adasum_allreduce(x).cpu().numpy()}
        if hvd.size() == 4 and hvd.local_size() == 2:
            os.environ["HVD_HIERARCHICAL_ALLREDUCE"] = "1"
            out["two"] = hvd.adasum_allreduce(x).cpu().numpy()
            del os.environ["HVD_HIERARCHICAL_ALLREDUCE"]
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


def _adasum_trainer_rank_on_card(out_path: str) -> None:
    """One rank of the full-width data-parallel trainer (8 x 2048 tokens a
    card, Adam) with ``op=Average`` and then ``op=Adasum`` from the same
    weights, ``CARD_STEPS`` steps each, the last three timed; on rank 0 one
    more Adasum step under ``torch.profiler``: whether the first bucket's
    NCCL kernel started before the backward pass's last kernel ended."""
    import tempfile
    import time
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import testing
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from torch.profiler import ProfilerActivity, profile

    hvd.init()
    try:
        rank = hvd.rank()
        cfg = TransformerConfig(attn_mode="ulysses")
        tokens = torch.from_numpy(np.random.default_rng(rank).integers(
            0, cfg.vocab_size, size=(8, 2048))).to(hvd.device())
        out = {}
        for name, op in (("average", hvd.Average), ("adasum", hvd.Adasum)):
            model = TransformerLM(cfg)
            model.reset_parameters(torch.Generator().manual_seed(0))
            opt = hvd.DistributedOptimizer(
                torch.optim.Adam(model.parameters(), lr=1e-3), op=op)

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
            losses += [step() for _ in range(CARD_STEPS - 2)]
            torch.cuda.synchronize()
            out[f"{name}_step_ms"] = ((time.perf_counter() - t0)
                                      / (CARD_STEPS - 2) * 1e3)
            out[f"{name}_losses"] = losses
            out[f"{name}_in_backward"] = opt.stats["started_in_backward"]
            if name == "adasum":
                if rank == 0:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        step()
                        torch.cuda.synchronize()
                    with tempfile.TemporaryDirectory() as tmp:
                        path = os.path.join(tmp, "trace.json")
                        prof.export_chrome_trace(path)
                        found = testing.backward_overlap(path)
                    out["overlap"] = bool(found["overlap"])
                    out["overlap_report"] = repr(found)
                else:
                    step()
            del model, opt
            torch.cuda.empty_cache()
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
    finally:
        hvd.shutdown()
