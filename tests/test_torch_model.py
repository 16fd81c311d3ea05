"""Parity of the PyTorch port's TransformerLM and DistributedOptimizer with
the JAX package's, on the CPU at a small size (2 layers, d_model 64, 4 heads,
d_ff 128, vocab 64, seq 32, float32).

The JAX model's weights go through ``from_flax_params`` into the port's
model; both see the same numpy tokens. The sequence-parallel modes
(``"ulysses"``, ``"ring"``, ``"ring_zigzag"``) run the JAX model under
``jax.shard_map`` over a one-device ``sp`` mesh (a sequence group of one
rank), the port on its flash wrappers' plain versions; worlds of 2 and 4
are in ``test_torch_sequence_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu_torch as thvd
from horovod_tpu.models import TransformerConfig as JConfig
from horovod_tpu.models import TransformerLM as JLM
from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                      from_flax_params, lm_loss)

SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128,
             max_seq_len=32)


@pytest.fixture(scope="module")
def torch_world():
    """A gloo world of one rank in this process for the port's collectives."""
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def _tokens(seed=0, batch=3, seq=32, vocab=64):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, vocab, size=(batch, 1))
    step = rng.integers(1, 7, size=(batch, 1))
    return ((start + step * np.arange(seq)[None]) % vocab).astype(np.int32)


def _jax_loss_fn(model, mode):
    def loss_fn(params, t):
        logits = model.apply({"params": params}, t)
        tgt = jnp.roll(t, -1, axis=1)
        loss = -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), tgt[..., None], -1)[:, :-1])
        return loss, logits

    fn = jax.value_and_grad(loss_fn, has_aux=True)
    if mode == "full":
        return jax.jit(fn)
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(), P()),
                                 out_specs=((P(), P()), P()),
                                 check_vma=False))


def _models(mode, seed=0):
    tokens = _tokens(seed)
    jmodel = JLM(JConfig(dtype=jnp.float32, attn_mode=mode, **SMALL))
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.asarray(tokens))["params"]
    params = jax.tree.map(lambda x: np.array(x, np.float32), params)
    tmodel = TransformerLM(TransformerConfig(dtype=torch.float32,
                                             attn_mode=mode, **SMALL),
                           device="cpu")
    tmodel.load_state_dict(from_flax_params(params))
    return jmodel, params, tmodel, tokens


@pytest.mark.parametrize("mode", ["ulysses", "full", "ring", "ring_zigzag"])
def test_transformer_logits_loss_and_grads_match_jax(mode):
    """Logits rtol 1e-4 atol 1e-5, loss rtol 1e-5, every parameter's
    gradient (mapped by the same weight-layout transform) rtol 1e-4 atol
    1e-6: float32 on both sides, differing only in summation order."""
    jmodel, params, tmodel, tokens = _models(mode)
    (jloss, jlogits), jgrads = _jax_loss_fn(jmodel, mode)(
        params, jnp.asarray(tokens))
    t = torch.from_numpy(tokens.astype(np.int64))
    logits = tmodel(t)
    loss = lm_loss(logits, t)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = from_flax_params(jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_from_flax_params_covers_every_parameter():
    """The importer fills exactly the port model's state_dict."""
    _, params, tmodel, _ = _models("full", seed=1)
    sd = from_flax_params(params)
    assert set(sd) == set(tmodel.state_dict())
    for name, t in tmodel.state_dict().items():
        assert tuple(sd[name].shape) == tuple(t.shape), name


def test_adam_steps_match_optax(torch_world):
    """3 steps of DistributedOptimizer(Adam) at a world of one (the average
    is the identity) against 3 steps of optax.adam, ulysses attention:
    parameters atol 2e-5 (lr 1e-2; Adam's normalized step amplifies
    float32 differences where a gradient is near zero), Adam's first and
    second moments rtol 1e-3 with atol 1e-6 and 1e-9."""
    jmodel, params, tmodel, tokens = _models("ulysses", seed=2)
    vg = _jax_loss_fn(jmodel, "ulysses")
    tx = optax.adam(1e-2)
    state = tx.init(params)
    jp = params
    for _ in range(3):
        (_, _), g = vg(jp, jnp.asarray(tokens))
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
    opt = thvd.DistributedOptimizer(
        torch.optim.Adam(tmodel.parameters(), lr=1e-2))
    t = torch.from_numpy(tokens.astype(np.int64))
    for _ in range(3):
        opt.zero_grad()
        lm_loss(tmodel(t), t).backward()
        opt.step()
    want = from_flax_params(jax.tree.map(np.asarray, jp))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)
    adam_state = state[0]
    mu = from_flax_params(jax.tree.map(np.asarray, adam_state.mu))
    nu = from_flax_params(jax.tree.map(np.asarray, adam_state.nu))
    for name, p in tmodel.named_parameters():
        st = opt.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   nu[name].numpy(), rtol=1e-3, atol=1e-9,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["nope", "Full", ""])
def test_config_validation_matches_jax(mode):
    """An unknown attention mode raises on both sides."""
    with pytest.raises(ValueError):
        JConfig(attn_mode=mode)
    with pytest.raises(ValueError):
        TransformerConfig(attn_mode=mode)


@pytest.mark.parametrize("kw", [dict(moe_experts=2, attn_mode="ring"),
                                dict(moe_experts=4,
                                     attn_mode="ring_zigzag"),
                                dict(moe_experts=2)])
def test_unported_modes_raise(kw):
    """Valid JAX configurations the port has not reached (the MoE FFN,
    under any attention mode) raise NotImplementedError naming their
    ROADMAP item, instead of running something else."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerLM(TransformerConfig(dtype=torch.float32, **SMALL, **kw),
                      device="cpu")


def test_model_defaults_to_the_card_unless_init_chose_a_device(
        torch_world, monkeypatch):
    """Without ``device`` the model goes to the device of ``init()``'s
    world (here the CPU, as the fixture asked), and before ``init()`` to
    the card."""
    from horovod_tpu_torch import runtime
    model = TransformerLM(TransformerConfig(dtype=torch.float32, **SMALL))
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    monkeypatch.setattr(runtime, "_state", None)
    assert runtime.default_device().type == "cuda"
    assert runtime.default_device("cpu") == torch.device("cpu")
