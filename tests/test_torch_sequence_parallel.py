"""The port's multi-rank sequence parallelism against the JAX package's, on
the CPU at worlds of 2 and 4.

Each world is a spawned gloo world (:func:`test_torch_world2.run_world`),
started once per module for each size, whose ranks run
:func:`test_torch_long_context._sequence_rank` on seeded numpy inputs: rank r
holds block r of the sequence. The reference is the JAX package's
``ring_attention`` / ``ulysses_attention`` / ``TransformerLM`` under
``jax.shard_map`` over a mesh of the first n CPU devices, with the same
blocks, on its jnp path (``use_pallas=False``); nothing in the JAX package
changes. Both sides compute in float32 (the port's plain flash versions
round no product to bf16 there), so they differ only in summation order:

* attention outputs and q/k/v gradients of sum((out - tgt)^2): rtol 1e-5,
  atol 1e-5 (values are of order 1 to 10; a query row that sees one key
  has dq = 0 exactly, and both sides compute float32 noise of
  (dp - D) . k there, up to a few 1e-6);
* the layout functions (``seq_to_heads``, ``zigzag_shard``): bitwise;
* ``TransformerLM`` (2 layers, d_model 32, 8 heads of 4) in ``ring``,
  ``ring_zigzag`` and ``ulysses``, weights through ``from_flax_params``:
  logits rtol 1e-4 atol 1e-5, every parameter's gradient on every rank rtol
  1e-4 atol 1e-6 (the tolerances of ``test_torch_model.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import TransformerConfig as JConfig
from horovod_tpu.models import TransformerLM as JLM
from horovod_tpu.parallel import sequence as jseq
from horovod_tpu_torch.models import from_flax_params
from horovod_tpu_torch.parallel import ring_attention
from test_torch_long_context import (ATTENTION_CASES, BLOCK, SP_D, SP_H,
                                     SP_MODEL, SP_MODES, ZIGZAG_CHUNK,
                                     layout_input, sp_inputs)
from test_torch_world2 import run_world

AXIS = "sp"
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), (AXIS,))


def _sharded(fn, n, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(n), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _put(x, n, spec=P(None, AXIS)):
    return jax.device_put(x, NamedSharding(_mesh(n), spec))


@pytest.fixture(scope="module")
def flax_params():
    tokens = sp_inputs(4)["tokens"]
    model = JLM(JConfig(dtype=jnp.float32, **SP_MODEL))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    return jax.tree.map(lambda x: np.array(x, np.float32), params)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory, flax_params):
    """``(n, inputs, per-rank results)`` of one gloo world of n ranks."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"sequence{n}")
    np.savez(tmp / "model.npz", **{k: v.numpy() for k, v in
                                   from_flax_params(flax_params).items()})
    ranks = run_world("_sequence_rank", tmp, size=n,
                      module="test_torch_long_context")
    return n, sp_inputs(n), ranks


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    """A world of odd size: the ring cases and the zigzag layout only (no
    head count of the models divides by 3)."""
    ranks = run_world("_ring_rank", tmp_path_factory.mktemp("sequence3"),
                      size=3, module="test_torch_long_context")
    return 3, sp_inputs(3), ranks


def _gathered(ranks, key):
    """The ranks' blocks of ``key`` put back in sequence order."""
    return np.concatenate([r[key] for r in ranks], axis=1)


def _jax_attention(n, inp, fn, kw):
    """Output and q/k/v gradients of sum((out - tgt)^2) from the JAX
    function under ``shard_map``, sequence on dim 1."""
    fn = {"ring": jseq.ring_attention, "ulysses": jseq.ulysses_attention}[fn]

    def loss(q, k, v, t):
        out = fn(q, k, v, AXIS, use_pallas=False, **kw)
        return jnp.sum((out - t) ** 2), out

    def per_rank(q, k, v, t):
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(q, k, v, t)
        return (out, *grads)

    spec = P(None, AXIS)
    res = _sharded(per_rank, n, (spec,) * 4, (spec,) * 4)(
        *(_put(inp[x], n) for x in ("q", "k", "v", "tgt")))
    return dict(zip(("out", "dq", "dk", "dv"), map(np.asarray, res)))


def _check_attention(world, case):
    n, inp, ranks = world
    name, fn, kw = case
    want = _jax_attention(n, inp, fn, kw)
    for key, ref in want.items():
        np.testing.assert_allclose(_gathered(ranks, f"{name}_{key}"), ref,
                                   err_msg=f"{name} {key}", **ATTN_TOL)


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=lambda c: c[0])
def test_attention_output_and_grads_match_jax(world, case):
    """Ring (causal and not), zigzag ring and Ulysses (causal and not):
    the output and the q, k, v gradients, gathered over the ranks, against
    the JAX function at the same world size."""
    _check_attention(world, case)


@pytest.mark.parametrize("case", [c for c in ATTENTION_CASES
                                  if c[1] == "ring"], ids=lambda c: c[0])
def test_odd_world_ring_matches_jax(world3, case):
    """The ring cases at a world of 3, where the zigzag routes two pieces
    between one pair of ranks in one direction (chunks 2 and 3 both go to
    rank 2)."""
    _check_attention(world3, case)


def test_seq_to_heads_layout_and_round_trip_match_jax(world):
    """Head chunk j goes to rank j and the received blocks concatenate in
    rank order, as ``lax.all_to_all(split_axis=2, concat_axis=1,
    tiled=True)``; ``heads_to_seq`` undoes it. Bitwise."""
    n, _, ranks = world
    x = layout_input(n)
    got = _sharded(lambda t: jseq.seq_to_heads(t, AXIS), n, P(None, AXIS),
                   P(None, None, AXIS))(_put(x, n))
    want = np.asarray(got)  # (b, seq, heads): rank r's heads at chunk r
    hl = SP_H // n
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["s2h"],
                                      want[:, :, r * hl:(r + 1) * hl])
        np.testing.assert_array_equal(
            res["s2h_back"], x[:, r * BLOCK:(r + 1) * BLOCK])


def test_zigzag_shard_and_round_trip_match_jax(world):
    """Rank r's halves become global chunks (r, 2n-1-r), as the JAX
    ``zigzag_shard`` places them; ``zigzag_unshard`` undoes it. Bitwise."""
    _check_zigzag_layout(world)


def test_odd_world_zigzag_shard_matches_jax(world3):
    """The same at a world of 3: rank 1 sends both its chunks, 2 and 3, to
    rank 2."""
    _check_zigzag_layout(world3)


def _check_zigzag_layout(world):
    n, _, ranks = world
    x = np.arange(2 * n * ZIGZAG_CHUNK, dtype=np.float32).reshape(1, -1, 1)
    want = np.asarray(_sharded(lambda t: jseq.zigzag_shard(t, AXIS), n,
                               P(None, AXIS), P(None, AXIS))(_put(x, n)))
    np.testing.assert_array_equal(_gathered(ranks, "zz"), want)
    np.testing.assert_array_equal(_gathered(ranks, "zz_back"), x)
    c = ZIGZAG_CHUNK
    for r, res in enumerate(ranks):
        hi = 2 * n - 1 - r
        np.testing.assert_array_equal(
            res["zz"].ravel(), np.r_[r * c:(r + 1) * c, hi * c:(hi + 1) * c])


def test_indivisible_heads_raise_as_jax(world):
    """3 heads over a group of 2 or 4: the reference's error text."""
    n, _, ranks = world
    with pytest.raises(ValueError) as err:
        _sharded(lambda t: jseq.seq_to_heads(t, AXIS), n, P(None, AXIS),
                 P(None, AXIS))(_put(np.zeros((1, BLOCK * n, 3, SP_D),
                                              np.float32), n))
    assert str(err.value) and "3" in str(err.value)
    for res in ranks:
        assert str(res["err_heads"]) == str(err.value)


@pytest.mark.parametrize("kw,sq,sk", [
    (dict(causal=False, schedule="zigzag"), 8, 8),
    (dict(schedule="zigzag"), 7, 7),
    (dict(schedule="zigzag"), 8, 6),
    (dict(schedule="zagzig"), 8, 8),
], ids=["zigzag-not-causal", "zigzag-odd", "zigzag-unequal", "unknown"])
def test_ring_errors_match_jax(kw, sq, sk):
    """Zigzag without causal masking, odd or unequal block lengths, an
    unknown schedule: the reference's error text (a group of one rank)."""
    q = np.zeros((1, sq, 2, SP_D), np.float32)
    k = np.zeros((1, sk, 2, SP_D), np.float32)
    with pytest.raises(ValueError) as want:
        _sharded(lambda q, k: jseq.ring_attention(
            q, k, k, AXIS, use_pallas=False, **kw), 1, (P(None, AXIS),) * 2,
            P(None, AXIS))(q, k)
    with pytest.raises(ValueError) as got:
        ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(k), **kw)
    assert str(got.value) == str(want.value)


def test_ring_residuals_are_one_block(world):
    """The counterpart of ``test_ring_attention_residuals_are_o_block``:
    ``_RingCore`` saves exactly (qf, kf, vf, out, lse), each one block of
    this rank's rows (one part of (bh, s, d), as the contiguous ring keeps
    its blocks), never a rotated K/V block; and every byte autograd saves
    through ``ring_attention`` is the same at worlds 2 and 4 (the block is
    the same), no more than 6 block-sized tensors."""
    n, _, ranks = world
    bh = 2 * SP_H
    block = [1, bh, BLOCK, SP_D]
    for res in ranks:
        shapes = res["ring_saved_shapes"].tolist()
        assert shapes == [block] * 4 + [[1, bh, BLOCK, 1]]
        assert int(res["ring_saved_bytes"]) == 4 * (4 * bh * BLOCK * SP_D
                                                    + bh * BLOCK)
        assert int(res["ring_saved_bytes"]) <= 6 * 4 * bh * BLOCK * SP_D


def _jax_model(n, mode, params, tokens):
    """Logits and every rank's parameter gradients of the block loss, from
    the flax model under ``shard_map`` over the sequence axis."""
    model = JLM(JConfig(dtype=jnp.float32, attn_mode=mode, seq_axis=AXIS,
                        **SP_MODEL))

    def per_rank(p, t):
        def loss_fn(p):
            logits = model.apply({"params": p}, t)
            tgt = jnp.roll(t, -1, axis=1)
            loss = -jnp.mean(jnp.take_along_axis(
                jax.nn.log_softmax(logits), tgt[..., None], -1)[:, :-1])
            return loss, logits

        (_, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return logits, jax.tree.map(lambda g: g[None], grads)

    logits, grads = _sharded(per_rank, n, (P(), P(None, AXIS)),
                             (P(None, AXIS), P(AXIS)))(
        params, _put(tokens, n))
    return np.asarray(logits), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("mode", SP_MODES)
def test_transformer_lm_matches_flax(world, flax_params, mode):
    """``TransformerLM`` in a sequence-parallel mode, weights from the flax
    model through ``from_flax_params``: each rank's logits of its block and
    its gradient of every parameter against the flax model's on the same
    device of the mesh."""
    n, inp, ranks = world
    logits, grads = _jax_model(n, mode, flax_params, inp["tokens"])
    np.testing.assert_allclose(_gathered(ranks, f"{mode}_logits"), logits,
                               rtol=1e-4, atol=1e-5)
    for r, res in enumerate(ranks):
        want = from_flax_params(jax.tree.map(lambda g: g[r], grads))
        for name, ref in want.items():
            np.testing.assert_allclose(
                res[f"{mode}_grad_{name}"], ref.numpy(), rtol=1e-4,
                atol=1e-6, err_msg=f"rank {r} {name}")
