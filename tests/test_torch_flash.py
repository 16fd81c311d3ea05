"""Parity of the PyTorch port's flash-attention wrappers with the JAX
package's Pallas kernels (run in interpret mode), on the CPU.

On CPU tensors the port's wrappers run their plain versions, so these tests
hold the plain versions (the arithmetic every CUDA kernel is compared with on
the card) to the Pallas kernels on the same numpy inputs;
``tests/test_torch_cuda.py`` holds the CUDA kernels to the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash as jflash
from horovod_tpu.parallel import sequence as jseq
from horovod_tpu_torch.ops import flash as tflash
from horovod_tpu_torch.parallel import sequence as tseq


def _np(x):
    return np.array(x, np.float32)  # a writable copy


def _carries(bh, sq, d):
    m = np.full((bh, sq, 1), jflash.NEG_INF, np.float32)
    return m, np.zeros((bh, sq, 1), np.float32), np.zeros((bh, sq, d),
                                                          np.float32)


def _both_forward(q, k, v, qpos0, kpos0, causal, dtype="float32"):
    """(JAX Pallas interpret, port) block updates of the same inputs."""
    m, l, acc = _carries(q.shape[0], q.shape[1], q.shape[2])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got_j = jflash.block_attend(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        jnp.asarray(qpos0, jnp.int32), jnp.asarray(kpos0, jnp.int32),
        causal, True, jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc))
    got_t = tflash.block_attend(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), qpos0, kpos0,
        causal, *(torch.from_numpy(x) for x in (m, l, acc)))
    return [_np(x) for x in got_j], [x.numpy() for x in got_t]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_q_tiling(monkeypatch, causal):
    """Several q and kv tiles on the JAX side (its scratch carry) against the
    port's one-block update; float32, rtol 1e-5, atol 1e-6 (the tolerance of
    the JAX package's own kernel-vs-jnp test)."""
    monkeypatch.setattr(jflash, "DEFAULT_Q_TILE", 4)
    monkeypatch.setattr(jflash, "DEFAULT_KV_TILE", 8)
    rng = np.random.default_rng(11)
    q, k, v = [rng.standard_normal((3, 16, 8)).astype(np.float32)
               for _ in range(3)]
    got_j, got_t = _both_forward(q, k, v, 0, 0, causal)
    for name, j, t in zip(("m", "l", "acc"), got_j, got_t):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_kernel_awkward_sizes(causal, dtype, tol):
    """Prime-ish sq/sk with a q offset: the port masks by bounds where the
    Pallas kernel pads. float32: rtol = atol = 1e-5. bfloat16: both sides
    take float32 scores from bf16 inputs and round p to bf16 before p.v, but
    the Pallas kernel rounds p against its running max tile by tile and the
    port against the block max, so rtol = atol = 2e-2 (a few bf16 ulps)."""
    rng = np.random.default_rng(31)
    q = rng.standard_normal((2, 13, 8)).astype(np.float32)
    k = rng.standard_normal((2, 11, 8)).astype(np.float32)
    v = rng.standard_normal((2, 11, 8)).astype(np.float32)
    got_j, got_t = _both_forward(q, k, v, 3, 0, causal, dtype)
    for name, j, t in zip(("m", "l", "acc"), got_j, got_t):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol, err_msg=name)


def _grad_inputs(rng, bh, sq, sk, d, qpos0, kpos0, causal):
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    dout = rng.standard_normal((bh, sq, d)).astype(np.float32)
    m, l, acc = jflash._attend_jnp(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(qpos0, jnp.int32),
        jnp.asarray(kpos0, jnp.int32), causal, *(jnp.asarray(x) for x in
                                                 _carries(bh, sq, d)))
    l_safe = jnp.maximum(l, 1e-30)
    lse = m + jnp.log(l_safe)
    D = jnp.sum(dout * (acc / l_safe), axis=-1, keepdims=True)
    return q, k, v, _np(lse), dout, _np(D)


def _both_grads(inputs, qpos0, kpos0, causal):
    got_j = jflash.flash_block_grads(
        *(jnp.asarray(x) for x in inputs), jnp.asarray(qpos0, jnp.int32),
        jnp.asarray(kpos0, jnp.int32), causal, interpret=True)
    got_t = tflash.flash_block_grads(
        *(torch.from_numpy(x) for x in inputs), qpos0, kpos0, causal)
    return [_np(x) for x in got_j], [x.numpy() for x in got_t]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernel_awkward_sizes(monkeypatch, causal):
    """Non-tile-aligned sq/sk (the JAX side pads to 16 x 16 with 8-row
    tiles); float32, rtol = atol = 1e-4 as in the JAX package's test."""
    monkeypatch.setattr(jflash, "DEFAULT_Q_TILE", 8)
    monkeypatch.setattr(jflash, "DEFAULT_KV_TILE", 8)
    rng = np.random.default_rng(37)
    inputs = _grad_inputs(rng, 2, 13, 11, 8, 2, 0, causal)
    got_j, got_t = _both_grads(inputs, 2, 0, causal)
    for name, j, t in zip(("dq", "dk", "dv"), got_j, got_t):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernel_multi_tile(monkeypatch, causal):
    """3 q tiles x 2 kv tiles on the JAX side, offset blocks as in a ring
    step; float32, rtol = atol = 1e-5 as in the JAX package's test."""
    monkeypatch.setattr(jflash, "DEFAULT_Q_TILE", 4)
    monkeypatch.setattr(jflash, "DEFAULT_KV_TILE", 4)
    rng = np.random.default_rng(21)
    inputs = _grad_inputs(rng, 2, 12, 8, 8, 4, 0, causal)
    got_j, got_t = _both_grads(inputs, 4, 0, causal)
    for name, j, t in zip(("dq", "dk", "dv"), got_j, got_t):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,qpos0,kpos0", [(13, 11, 2, 0), (300, 40, 0, 200),
                                               (130, 200, 0, 70), (8, 8, 50, 0)])
def test_live_keys_count_unmasked_scores(sq, sk, qpos0, kpos0, causal):
    """``live_keys`` (the keys each query row takes part with, used by the
    card's checks) against the unmasked entries of each row of the JAX
    ``causal_mask_scores``, exactly."""
    s = jnp.zeros((sq, sk), jnp.float32)
    if causal:
        s = jflash.causal_mask_scores(s, jnp.int32(qpos0), jnp.int32(kpos0))
    want = np.sum(np.asarray(s) > jflash.NEG_INF / 2, axis=-1)
    got = tflash.live_keys(sq, sk, qpos0, kpos0, causal)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
def test_local_flash_forward_and_gradients(causal):
    """The port's ``_local_flash`` (its autograd Function over the wrappers)
    against the JAX ``_local_flash`` on the Pallas kernels in interpret
    mode: float32, outputs rtol 1e-5 atol 1e-6, gradients of a random
    cotangent rtol 1e-4 atol 1e-5."""
    rng = np.random.default_rng(5)
    q, k, v, ct = [rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
                   for _ in range(4)]
    out_j, vjp = jax.vjp(
        lambda q, k, v: jseq._local_flash(q, k, v, causal, False, True),
        *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(ct))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out_t = tseq._local_flash(qt, kt, vt, causal)
    out_t.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out_t.detach().numpy(), _np(out_j),
                               rtol=1e-5, atol=1e-6)
    for name, j, t in zip("qkv", grads_j, (qt, kt, vt)):
        np.testing.assert_allclose(t.grad.numpy(), _np(j), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")
