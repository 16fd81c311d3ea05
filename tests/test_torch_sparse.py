"""The port's sparse (indexed-rows) gradient path against the JAX package's
(``tests/test_sparse.py``'s cases).

Row extraction and scatter run in this process. The reductions run in a
spawned gloo world of 2 (started once for the module by
:func:`test_torch_world2.run_world`) whose ranks run :func:`_sparse_rank`,
which imports no JAX; the reference takes the same per-rank inputs on two
devices of the conftest's 8-device CPU mesh, eagerly on a JAX process set
or under ``jax.shard_map`` over a mesh of those two. Under that mesh the
reference's sparse AVERAGE divides by the size of its global process set
(8, not the mesh's 2), and its eager sparse AVERAGE does not take
``per_rank`` bundles, so the reference comparisons run SUM, and AVERAGE is
held to the reference's rule (the values divided by the set's size, then
SUM). Inputs are integer-valued, so the reductions are bitwise; trained
embeddings agree within 1e-6 (the sparse route halves each rank's rows
before it sums them, the dense one sums, then halves).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world

VOCAB, DIM = 32, 4
MAX_ROWS = 4
STEPS, LR = 3, 0.1


def dense_grad_for_rank(r: int, n: int) -> np.ndarray:
    """Rank r touches rows {r, r+1, n+5} with known values (the
    reference test's gradient)."""
    g = np.zeros((VOCAB, DIM), np.float32)
    g[r] = r + 1.0
    g[r + 1] += 2.0
    g[n + 5] += 10.0 + r
    return g


def rows_for_rank(r: int):
    """The reference's eager case: values full of r at rows [r, 0]."""
    return (np.full((2, DIM), float(r), np.float32),
            np.asarray([r, 0], np.int32))


def embedding_problem():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, VOCAB, size=(8, 3)),
            "targets": rng.standard_normal((8, 3, DIM)).astype(np.float32),
            "table": rng.standard_normal((VOCAB, DIM)).astype(np.float32),
            "w": np.ones((DIM,), np.float32)}


def scaled_grads(r: int) -> dict:
    """Integer-valued gradients of the scaling-and-compression case."""
    emb = np.zeros((VOCAB, DIM), np.float32)
    emb[[2 * r, 7, 20 + r]] = np.arange(3 * DIM, dtype=np.float32).reshape(
        3, DIM) + 10 * r
    return {"emb.table": emb, "w": np.full((3,), 4.0 + r, np.float32)}


def _sparse_rank(out_path: str) -> None:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import sparse

    hvd.init(device="cpu")
    try:
        rank, n = hvd.rank(), hvd.size()
        out = {}
        values, indices = (torch.from_numpy(a) for a in rows_for_rank(rank))
        rows = hvd.SparseRows(values, indices, VOCAB)
        for op in ("Sum", "Average"):
            red = hvd.sparse_allreduce(rows, op=getattr(hvd, op))
            out.update({f"{op}_values": red.values, f"{op}_indices":
                        red.indices, f"{op}_dense": sparse.rows_to_dense(red)})
        red = hvd.sparse_allreduce_async(rows, op=hvd.Sum).synchronize()
        out.update(async_values=red.values, async_indices=red.indices)
        g = torch.from_numpy(dense_grad_for_rank(rank, n))
        for op in ("Sum", "Average"):
            out[f"to_dense_{op}"] = hvd.sparse_allreduce_to_dense(
                g, MAX_ROWS, op=getattr(hvd, op))
            os.environ["HVD_SPARSE_AS_DENSE"] = "1"
            out[f"as_dense_{op}"] = hvd.sparse_allreduce_to_dense(
                g, 1, op=getattr(hvd, op))
            del os.environ["HVD_SPARSE_AS_DENSE"]
        # an embedding trained through the sparse route and the dense one
        prob = embedding_problem()
        mine = slice(rank * 4, (rank + 1) * 4)
        tok = torch.from_numpy(prob["tokens"][mine])
        tgt = torch.from_numpy(prob["targets"][mine])
        for route in ("dense", "sparse", "sparse_sum"):
            model = torch.nn.ParameterDict({
                k: torch.nn.Parameter(torch.tensor(prob[k]))
                for k in ("table", "w")})
            kw = {} if route == "dense" else dict(
                sparse_gradient_paths=["table"], sparse_max_rows=12)
            if route == "sparse_sum":
                kw["op"] = hvd.Sum
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=LR),
                named_parameters=model.named_parameters(), **kw)
            for _ in range(STEPS):
                opt.zero_grad()
                emb = model["table"][tok] * model["w"]
                ((emb - tgt) ** 2).mean().backward()
                opt.step()
            out.update({f"{route}_{k}": v.detach()
                        for k, v in model.items()})
        # scaling and fp16 compression on both routes
        grads = {k: torch.from_numpy(v) for k, v in scaled_grads(rank).items()}
        for route in ("dense", "sparse"):
            params = {k: torch.nn.Parameter(torch.zeros_like(v))
                      for k, v in grads.items()}
            kw = {} if route == "dense" else dict(
                sparse_gradient_paths=["emb"], sparse_max_rows=VOCAB)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(params.values(), lr=1.0),
                named_parameters=params.items(), op=hvd.Sum,
                compression=hvd.Compression.fp16, prescale_factor=0.5,
                postscale_factor=2.0, **kw)
            opt.zero_grad()
            sum((params[k] * g).sum() for k, g in grads.items()).backward()
            opt.synchronize()
            out.update({f"scaled_{route}_{k}": p.grad
                        for k, p in params.items()})
        np.savez(out_path, **{k: v.numpy() for k, v in out.items()})
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("_sparse_rank", tmp_path_factory.mktemp("sparse2"),
                     size=2, module="test_torch_sparse")


@pytest.fixture
def pset2(hvd):
    ps = hvd.add_process_set([0, 1])
    yield ps
    hvd.remove_process_set(ps)


@pytest.fixture(scope="module")
def mesh2():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:2]), ("hvd",))


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- in this process --------------------------------------------------------

@pytest.mark.parametrize("max_rows", [2, 3, 6, 40])
@pytest.mark.parametrize("r", [0, 2, 5])
def test_rows_round_trip_matches_jax(max_rows, r):
    """The same rows (ties to the lower index, as ``lax.top_k``), int32
    indices, and the same dense table back, bitwise."""
    import jax.numpy as jnp
    from horovod_tpu.ops import sparse as ref
    from horovod_tpu_torch.ops import sparse
    g = dense_grad_for_rank(r, 8)
    want = ref.rows_from_dense(jnp.asarray(g), max_rows)
    got = sparse.rows_from_dense(torch.from_numpy(g), max_rows)
    _same(got.indices.numpy(), want.indices)
    _same(got.values.numpy(), want.values)
    assert got.num_rows == want.num_rows == VOCAB
    _same(sparse.rows_to_dense(got).numpy(), ref.rows_to_dense(want))


def test_rows_to_dense_sums_duplicates_as_jax():
    import jax.numpy as jnp
    from horovod_tpu.ops import sparse as ref
    from horovod_tpu_torch.ops import sparse
    values = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.asarray([1, 5, 1, 0], np.int32)
    want = ref.rows_to_dense(ref.SparseRows(jnp.asarray(values),
                                            jnp.asarray(idx), 6))
    got = sparse.rows_to_dense(sparse.SparseRows(
        torch.from_numpy(values), torch.from_numpy(idx), 6))
    _same(got.numpy(), want)


def test_rows_from_dense_requires_2d():
    from horovod_tpu_torch.ops import sparse
    with pytest.raises(ValueError, match="2-D"):
        sparse.rows_from_dense(torch.zeros(4), 2)


@pytest.mark.parametrize("op", ["Max", "Min", "Product"])
def test_sparse_rejects_other_ops_as_jax(hvd, op):
    from horovod_tpu.ops import sparse as ref
    from horovod_tpu_torch.ops import sparse
    import horovod_tpu_torch as thvd
    import jax.numpy as jnp
    with pytest.raises(ValueError) as theirs:
        ref.sparse_allreduce(ref.SparseRows(
            jnp.zeros((1, DIM)), jnp.zeros((1,), jnp.int32), VOCAB),
            op=getattr(hvd, op))
    with pytest.raises(ValueError) as mine:
        sparse.sparse_allreduce(sparse.SparseRows(
            torch.zeros(1, DIM), torch.zeros(1, dtype=torch.int32), VOCAB),
            op=getattr(thvd, op))
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("name,paths,rows", [
    ("model/embedding/table", ["embedding"], 8),
    ("model/dense/w", ["embedding"], 8),
    ("a/emb1/t", ["emb"], {"emb1": 4, "emb2": 6}),
    ("a/emb3/t", ["emb"], {"emb1": 4}),
    ("embed.weight", ["^embed\\."], 16384),
    ("lm_head.weight", ["^embed\\."], 16384),
])
def test_sparse_max_rows_matches_jax(name, paths, rows):
    """An int or a dict of regexes; no dict entry for a matching name
    raises, with the reference's text."""
    from horovod_tpu.optim import _sparse_rows_for as ref
    from horovod_tpu_torch.optim import _sparse_rows_for as ours
    try:
        want = ref(name, paths, rows)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            ours(name, paths, rows)
        assert str(err.value) == str(e)
        return
    assert ours(name, paths, rows) == want


# -- the world of 2 -----------------------------------------------------------

@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_sparse_allreduce_matches_jax(hvd, world2, pset2, op):
    """Values and indices gathered in rank order, and their dense sum, as
    the reference's eager path on a set of two; AVERAGE as its rule says:
    the values halved, then SUM."""
    from horovod_tpu.ops import sparse as ref
    scale = np.float32(1 if op == "Sum" else 2)
    vals, idxs = zip(*(rows_for_rank(r) for r in range(2)))
    rows = ref.SparseRows(hvd.per_rank([v / scale for v in vals], pset2),
                          hvd.per_rank(list(idxs), pset2), VOCAB)
    want = ref.sparse_allreduce(rows, op=hvd.Sum, process_set=pset2)
    dense = ref.rows_to_dense(ref.SparseRows(np.asarray(want.values),
                                             np.asarray(want.indices), VOCAB))
    for res in world2:
        _same(res[f"{op}_values"], want.values)
        _same(res[f"{op}_indices"], want.indices)
        _same(res[f"{op}_dense"], dense)


def test_sparse_allreduce_async_matches_sync(world2):
    for res in world2:
        _same(res["async_values"], res["Sum_values"])
        _same(res["async_indices"], res["Sum_indices"])


@pytest.mark.parametrize("as_dense", [False, True])
def test_sparse_allreduce_to_dense_matches_jax(hvd, world2, mesh2,
                                               as_dense):
    """``sparse_allreduce_to_dense`` (SUM) against the reference under
    ``shard_map``, and AVERAGE against the dense mean; with
    ``HVD_SPARSE_AS_DENSE`` both take a dense allreduce (the port's rank
    asks for one row, which the sparse route would cut short)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.ops import sparse as ref
    from horovod_tpu.utils import envs
    dense = np.stack([dense_grad_for_rank(r, 2) for r in range(2)])
    fn = jax.jit(jax.shard_map(
        lambda g: ref.sparse_allreduce_to_dense(
            g[0], MAX_ROWS if not as_dense else 1, op=hvd.Sum)[None],
        mesh=mesh2, in_specs=P("hvd"), out_specs=P("hvd"), check_vma=False))
    if as_dense:
        envs.set_override("SPARSE_AS_DENSE", "1")
    try:
        want = np.asarray(fn(dense))
    finally:
        if as_dense:
            envs.clear_override("SPARSE_AS_DENSE")
    _same(want[0], dense.sum(axis=0))
    key = "as_dense" if as_dense else "to_dense"
    for r, res in enumerate(world2):
        _same(res[f"{key}_Sum"], want[r])
        _same(res[f"{key}_Average"], dense.mean(axis=0))


def test_optimizer_sparse_route_matches_dense_route(world2):
    """An embedding trained 3 SGD steps through the sparse route and the
    dense route (the reference's case, at world 2): within 1e-6."""
    for res in world2:
        for k in ("table", "w"):
            np.testing.assert_allclose(res[f"sparse_{k}"], res[f"dense_{k}"],
                                       rtol=0, atol=1e-6)
    np.testing.assert_array_equal(world2[0]["sparse_table"],
                                  world2[1]["sparse_table"])


def test_optimizer_sparse_route_matches_jax(hvd, world2, mesh2):
    """The same training (SUM) through the reference's
    ``DistributedOptimizer(sparse_gradient_paths=...)`` under
    ``shard_map``: within 1e-6."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    prob = embedding_problem()
    tx = hvd.DistributedOptimizer(optax.sgd(LR), op=hvd.Sum,
                                  sparse_gradient_paths=["table"],
                                  sparse_max_rows=12)
    params = {"table": jnp.asarray(prob["table"]),
              "w": jnp.asarray(prob["w"])}
    state = tx.init(params)

    def loss_fn(p, tok, tgt):
        return jnp.mean((p["table"][tok] * p["w"] - tgt) ** 2)

    def step(p, s, tok, tgt):
        g = jax.grad(loss_fn)(p, tok, tgt)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    fn = jax.jit(jax.shard_map(step, mesh=mesh2,
                               in_specs=(P(), P(), P("hvd"), P("hvd")),
                               out_specs=(P(), P()), check_vma=False))
    for _ in range(STEPS):
        params, state = fn(params, state, prob["tokens"], prob["targets"])
    for res in world2:
        for k in ("table", "w"):
            np.testing.assert_allclose(res[f"sparse_sum_{k}"],
                                       np.asarray(params[k]), rtol=0,
                                       atol=1e-6)


def test_sparse_route_scaling_and_compression_matches_jax(hvd, world2,
                                                          mesh2):
    """prescale 0.5, fp16 on the wire and postscale 2.0 bracket the sparse
    route as the dense one, as in the reference's ``_allreduce_tree`` (SUM;
    bitwise: integer-valued gradients)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.ops.compression import Compression
    from horovod_tpu.optim import _allreduce_tree
    tree = {k: np.stack([scaled_grads(r)[k] for r in range(2)])
            for k in ("emb.table", "w")}
    for route in ("dense", "sparse"):
        paths = ["emb"] if route == "sparse" else None
        fn = jax.jit(jax.shard_map(
            lambda t: _allreduce_tree(
                {k: v[0] for k, v in t.items()}, op=hvd.ReduceOp.SUM,
                process_set=None, compression=Compression.fp16,
                prescale_factor=0.5, postscale_factor=2.0, axis_name=None,
                sparse_gradient_paths=paths, sparse_max_rows=VOCAB),
            mesh=mesh2, in_specs=(P("hvd"),), out_specs=P(),
            check_vma=False))
        want = fn(tree)
        for res in world2:
            for k in ("emb.table", "w"):
                _same(res[f"scaled_{route}_{k}"], want[k])
