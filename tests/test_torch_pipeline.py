"""Pipeline parallelism of the PyTorch port against the JAX package's:
``pipeline_apply`` and ``microbatch``, and the twin of
``examples/pipeline_train.py``.

The port side runs in spawned gloo worlds of 2 and 4 ranks, one stage a
rank (:func:`_pipeline_rank`, which imports no JAX), and the twin in a
world of 4 as dp 2 x pp 2 (:func:`_pipeline_twin_rank`). The reference runs
under ``jax.shard_map`` over a sub-mesh of the conftest's CPU devices, as
``tests/test_pipeline.py`` runs it; the sequential application of the same
stages runs here in torch. float32 throughout; tolerances as the
reference's tests: outputs rtol 1e-5 atol 1e-6, gradients rtol 1e-4 atol
1e-6, the input cotangent rtol 1e-4 atol 1e-7 and bitwise the same on
every stage, the twin's first-step loss rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from test_torch_world2 import run_world

DIM, BATCH = 8, 8
N_MICRO = (1, 4)
REMAT = (False, True)


def stages(n: int) -> list:
    rng = np.random.default_rng(10 + n)
    return [{"w": (rng.standard_normal((DIM, DIM)) / np.sqrt(DIM)).astype(
                np.float32),
             "b": (rng.standard_normal(DIM) * 0.1).astype(np.float32)}
            for _ in range(n)]


def pipe_data(n: int) -> tuple:
    rng = np.random.default_rng(20 + n)
    return (rng.standard_normal((BATCH, DIM)).astype(np.float32),
            rng.standard_normal((BATCH, DIM)).astype(np.float32))


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _pipeline_rank(out_path: str, device: str | None = "cpu") -> None:
    """One stage a rank: for each microbatch count and remat setting, the
    output, the stage's gradients and the input cotangent of ``mean((out -
    tgt)**2)``, saved."""
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import pipeline_apply

    hvd.init(device=device)
    try:
        n, rank, dev = hvd.size(), hvd.rank(), hvd.device()
        x_np, tgt = (torch.from_numpy(a).to(dev) for a in pipe_data(n))
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        out = {}
        for m in N_MICRO:
            for remat in REMAT:
                p = {k: torch.from_numpy(v).to(dev).requires_grad_()
                     for k, v in stages(n)[rank].items()}
                x = x_np.clone().requires_grad_()
                y = pipeline_apply(lambda h: _stage_fn(p, h), x,
                                   dist.group.WORLD, n_microbatches=m,
                                   remat=remat, params=p.values())
                ((y - tgt) ** 2).mean().backward()
                key = f"m{m}_remat{int(remat)}_"
                out.update({key + "out": host(y),
                            key + "gw": host(p["w"].grad),
                            key + "gb": host(p["b"].grad),
                            key + "gx": host(x.grad)})
        np.savez(out_path, **out)
    finally:
        hvd.shutdown()


def _pipeline_rank_on_card(out_path: str) -> None:
    _pipeline_rank(out_path, device=None)


def _pipeline_twin_rank(out_path: str) -> None:
    """The twin's smoke run, small model, dp 2 x pp 2: its losses."""
    from horovod_tpu_torch.examples import pipeline_train
    res = pipeline_train.main(["--smoke", "--device", "cpu", "--model",
                               "small", "--pp", "2"])
    np.savez(out_path, losses=np.asarray(res["losses"]))


def _sequential(n):
    """Output, stage gradients and input cotangent of the stages applied
    one after another, in torch."""
    ps = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
          for p in stages(n)]
    x_np, tgt = pipe_data(n)
    x = torch.from_numpy(x_np).requires_grad_()
    h = x
    for p in ps:
        h = _stage_fn(p, h)
    ((h - torch.from_numpy(tgt)) ** 2).mean().backward()
    return (h.detach().numpy(), [p["w"].grad.numpy() for p in ps],
            [p["b"].grad.numpy() for p in ps], x.grad.numpy())


def _jax_pipeline(n, n_micro):
    """The reference ``pipeline_apply`` over n devices: output, stacked
    stage gradients, and every device's input cotangent."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from horovod_tpu.parallel import (pipeline_apply, stack_stage_params,
                                      unstack_stage)
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))
    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()}
                                  for p in stages(n)])
    stacked = jax.device_put(stacked, NamedSharding(mesh, P("pp")))
    x, tgt = (jnp.asarray(a) for a in pipe_data(n))
    fn = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])  # noqa: E731

    def loss(p, x):
        out = pipeline_apply(fn, unstack_stage(p), x, "pp",
                             n_microbatches=n_micro)
        return jnp.mean((out - tgt) ** 2), out

    def body(p, x):
        (_, out), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, x)
        return out, gp, gx[None]

    out, gp, gx = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("pp"), P()),
        out_specs=(P(), P("pp"), P("pp")), check_vma=False))(stacked, x)
    return (np.asarray(out), np.asarray(gp["w"]), np.asarray(gp["b"]),
            np.asarray(gx))


@pytest.fixture(scope="module", params=[2, 4], ids=["pp2", "pp4"])
def pipe_world(request, tmp_path_factory):
    n = request.param
    return n, run_world("_pipeline_rank", tmp_path_factory.mktemp(
        f"pipe{n}"), size=n, module="test_torch_pipeline")


@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pipeline_output_matches_sequential_and_jax(pipe_world, n_micro):
    """Every stage holds the last stage's output, equal to the stages
    applied in sequence and to the reference's (rtol 1e-5, atol 1e-6)."""
    n, ranks = pipe_world
    seq_out = _sequential(n)[0]
    jax_out = _jax_pipeline(n, n_micro)[0]
    for remat in REMAT:
        for r, res in enumerate(ranks):
            got = res[f"m{n_micro}_remat{int(remat)}_out"]
            np.testing.assert_allclose(got, seq_out, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, jax_out, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pipeline_stage_gradients_match(pipe_world, n_micro, remat):
    """d(loss)/d(stage r's params) on rank r, with the loss computed on
    every stage, counts the loss once: equal to the sequential gradients
    and the reference's (rtol 1e-4, atol 1e-6), with and without
    ``remat``."""
    n, ranks = pipe_world
    _, seq_w, seq_b, _ = _sequential(n)
    _, jax_w, jax_b, _ = _jax_pipeline(n, n_micro)
    for r, res in enumerate(ranks):
        key = f"m{n_micro}_remat{int(remat)}_"
        for got, seq, ref in ((res[key + "gw"], seq_w[r], jax_w[r]),
                              (res[key + "gb"], seq_b[r], jax_b[r])):
            np.testing.assert_allclose(got, seq, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pipeline_input_cotangent_on_every_stage(pipe_world, n_micro):
    """d(loss)/dx is the whole sequential input cotangent (rtol 1e-4, atol
    1e-7), bitwise the same on every stage, and equal to the reference's
    on each device."""
    n, ranks = pipe_world
    seq_gx = _sequential(n)[3]
    jax_gx = _jax_pipeline(n, n_micro)[3]
    for remat in REMAT:
        key = f"m{n_micro}_remat{int(remat)}_gx"
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[key], ranks[0][key])
            np.testing.assert_allclose(res[key], seq_gx, rtol=1e-4,
                                       atol=1e-7)
            np.testing.assert_allclose(res[key], jax_gx[r], rtol=1e-4,
                                       atol=1e-7)


def test_microbatch_validates():
    from horovod_tpu_torch.parallel import microbatch
    with pytest.raises(ValueError, match="divide"):
        microbatch(torch.zeros((10, 2)), 4)
    assert microbatch(torch.zeros((8, 2)), 4).shape == (4, 2, 2)


def _jax_twin_first_loss(dp=2, pp=2):
    """The first step's loss of the reference example
    (``examples/pipeline_train.py``, its model and draws) over a dp x pp
    sub-mesh, averaged over dp."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from horovod_tpu.parallel import (pipeline_apply, stack_stage_params,
                                      unstack_stage)
    mesh = Mesh(np.array(jax.devices()[:dp * pp]).reshape(dp, pp),
                ("dp", "pp"))
    vocab, d_model, seq, layers_per_stage = 64, 32, 16, 2
    rng = np.random.default_rng(0)

    def init_block():
        return {"wi": jnp.asarray(
                    rng.standard_normal((d_model, 4 * d_model)) * 0.05,
                    jnp.float32),
                "wo": jnp.asarray(
                    rng.standard_normal((4 * d_model, d_model)) * 0.05,
                    jnp.float32)}

    params = {
        "embed": jnp.asarray(rng.standard_normal((vocab, d_model)) * 0.1,
                             jnp.float32),
        "stages": stack_stage_params(
            [{"blocks": [init_block() for _ in range(layers_per_stage)]}
             for _ in range(pp)]),
        "head": jnp.asarray(rng.standard_normal((d_model, vocab)) * 0.1,
                            jnp.float32),
    }
    tokens = rng.integers(0, vocab, (8 * dp, seq + 1))

    def stage_fn(stage_params, h):
        for blk in stage_params["blocks"]:
            h = h + jnp.tanh(h @ blk["wi"]) @ blk["wo"]
        return h

    def loss_fn(p, x, y):
        h = p["embed"][x]
        h = pipeline_apply(stage_fn, unstack_stage(p["stages"]), h, "pp",
                           n_microbatches=4)
        logits = h @ p["head"]
        return -jnp.mean(jnp.sum(jax.nn.one_hot(y, vocab)
                                 * jax.nn.log_softmax(logits), -1))

    specs = {"embed": P(), "head": P(),
             "stages": jax.tree.map(lambda _: P("pp"), params["stages"])}
    fn = jax.jit(jax.shard_map(
        lambda p, x, y: jax.lax.pmean(loss_fn(p, x, y), "dp"), mesh=mesh,
        in_specs=(specs, P("dp"), P("dp")), out_specs=P(), check_vma=False))
    return float(fn(params, tokens[:, :-1], tokens[:, 1:]))


def test_pipeline_twin_dp2_pp2_matches_jax(tmp_path):
    """The twin (``--smoke --device cpu --model small --pp 2``) in a gloo
    world of 4: its loss falls on every rank (the twin raises where it does
    not), every rank reports the same dp average, and the first step's
    loss equals the reference example's on the same weights and tokens
    (rtol 1e-5)."""
    ranks = run_world("_pipeline_twin_rank", tmp_path, size=4,
                      module="test_torch_pipeline")
    want = _jax_twin_first_loss()
    for res in ranks:
        losses = res["losses"]
        assert losses[-1] < losses[0]
        np.testing.assert_array_equal(losses, ranks[0]["losses"])
        np.testing.assert_allclose(losses[0], want, rtol=1e-5)
