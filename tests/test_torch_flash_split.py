"""The precision design of the bf16 backward kernels (``csrc/flash_bwd_dq.cu``
and ``csrc/flash_bwd_dkv.cu``), emulated in plain PyTorch on the CPU.

The Pallas kernels multiply fp32 operands in two of their products: dO in
dp = dO . v^T and in dv = p^T . dO, and the unrounded p in dv. The CUDA
kernels run every product on bf16 tensor cores, so they split each fp32
operand into bf16 parts, x = hi + lo (+ lo2), and sum the products of the
parts in fp32. These tests hold that emulation to the plain versions
(``plain_bwd_dq`` and ``plain_bwd_dkv``, themselves held to the Pallas
kernels in ``test_torch_flash.py``) per row, and show why dq and dk, whose
ds is rounded to bf16 inside the function, are held to a looser per-row
limit than dv on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash as jflash
from horovod_tpu_torch.ops import flash as tflash


def _parts(x, n):
    """x (fp32) as n bf16 parts, widened to fp32, whose sum is x to about
    8 n bits."""
    parts = []
    for _ in range(n):
        part = x.to(torch.bfloat16).float()
        parts.append(part)
        x = x - part
    return parts


def _row_errs(x, y):
    return (x - y).norm(dim=-1) / y.norm(dim=-1).clamp_min(1e-30)


def _row_rel(x, y):
    return _row_errs(x, y).max()


def _dq_row_errs(x, y, sk, qpos0, kpos0, causal):
    """As ``_row_errs``, but absolute on the query rows that see exactly one
    key: their dq is 0 in exact arithmetic (the one softmax weight is 1
    whatever q is), and any two orders of summation give fp32 noise of
    (dp - D) . k there."""
    one = tflash.live_keys(x.shape[1], sk, qpos0, kpos0, causal) == 1
    return torch.where(one, (x - y).norm(dim=-1), _row_errs(x, y))


def _inputs(bh, sq, sk, d, qpos0, kpos0, causal, seed):
    """Seeded bf16 q/k/v (q pre-scaled), fp32 dO, and the lse and D of a
    real forward pass, computed by the JAX package's jnp reference."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((bh, sq, d)) / np.sqrt(d)).astype(np.float32)
    k, v = (rng.standard_normal((bh, sk, d)).astype(np.float32)
            for _ in range(2))
    dout = rng.standard_normal((bh, sq, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    m0 = np.full((bh, sq, 1), jflash.NEG_INF, np.float32)
    m, l, acc = jflash._attend_jnp(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
        jnp.asarray(qpos0, jnp.int32), jnp.asarray(kpos0, jnp.int32), causal,
        jnp.asarray(m0), jnp.zeros((bh, sq, 1), jnp.float32),
        jnp.zeros((bh, sq, d), jnp.float32))
    l_safe = jnp.maximum(l, 1e-30)
    lse = torch.from_numpy(np.array(m + jnp.log(l_safe), np.float32))
    D = torch.from_numpy(np.array(
        jnp.sum(jnp.asarray(dout) * (acc / l_safe), axis=-1, keepdims=True),
        np.float32))
    return q, k, v, lse, torch.from_numpy(dout), D


SHAPES = [(2, 63, 65, 0, 0, True), (2, 129, 127, 0, 0, False),
          (2, 130, 200, 0, 70, True), (1, 256, 256, 0, 0, True)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_bf16_products_match_fp32(shape, d):
    """dp = dO . v^T with dO as hi + lo, and dv = p_hi^T . dO_hi +
    p_hi^T . dO_lo + p_lo^T . dO_hi, against the plain version's fp32
    products: 1e-4 per row (about 2^-16 relative a part is expected). The
    kernel's dp takes dO in three parts: 1e-6 per row."""
    bh, sq, sk, qpos0, kpos0, causal = shape
    q, k, v, lse, dout, D = _inputs(bh, sq, sk, d, qpos0, kpos0, causal,
                                    seed=sq + sk + d)
    p, _ = tflash._plain_ds(q, k, v, lse, dout, D, qpos0, kpos0, causal)
    vf = v.float()
    dp = torch.einsum("bqd,bkd->bqk", dout, vf)
    dp2, dp3 = (sum(torch.einsum("bqd,bkd->bqk", part, vf)
                    for part in _parts(dout, n)) for n in (2, 3))
    assert _row_rel(dp2, dp) <= 1e-4
    assert _row_rel(dp3, dp) <= 1e-6
    (p_hi, p_lo), (o_hi, o_lo) = _parts(p, 2), _parts(dout, 2)
    dv = sum(torch.einsum("bqk,bqd->bkd", a, b)
             for a, b in ((p_hi, o_hi), (p_hi, o_lo), (p_lo, o_hi)))
    _, dv_plain = tflash.plain_bwd_dkv(q, k, v, lse, dout, D, qpos0, kpos0,
                                       causal)
    assert _row_rel(dv, dv_plain) <= 1e-4


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_dq_arithmetic_matches_plain(shape, d):
    """The bf16 dq kernel's arithmetic: dp = hi . v^T + mid . v^T +
    lo . v^T with dO in three bf16 parts, ds = p (dp - D) rounded to bf16,
    and dq = bf16(ds) . k summed in fp32, against ``plain_bwd_dq`` (fp32 dp)
    on the same scores: the three parts keep dp within 1e-6 per row, so
    bf16(ds) rarely lands on the other neighbour; every row within 1e-2
    and the 90th-percentile row within 1e-4, the card's limits."""
    bh, sq, sk, qpos0, kpos0, causal = shape
    q, k, v, lse, dout, D = _inputs(bh, sq, sk, d, qpos0, kpos0, causal,
                                    seed=sq + sk + d)
    p, _ = tflash._plain_ds(q, k, v, lse, dout, D, qpos0, kpos0, causal)
    dp = sum(torch.einsum("bqd,bkd->bqk", part, v.float())
             for part in _parts(dout, 3))
    ds = (p * (dp - D)).to(torch.bfloat16).float()
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    rows = _dq_row_errs(dq, tflash.plain_bwd_dq(q, k, v, lse, dout, D, qpos0,
                                                kpos0, causal),
                        sk, qpos0, kpos0, causal)
    assert rows.max() <= 1e-2
    assert torch.quantile(rows.flatten(), 0.9) <= 1e-4


# The gradients whose ds is rounded to bf16 before their product:
# gradient -> (ds in fp32, q, k) -> that product in fp32.
ROUNDED_GRADS = {
    "dk": lambda ds, q, k: torch.einsum("bqk,bqd->bkd", ds, q.float()),
    "dq": lambda ds, q, k: torch.einsum("bqk,bkd->bqd", ds, k.float()),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "grad,shape",
    [(g, s) for g in ROUNDED_GRADS for s in ((1, 2048, 2048), (2, 1024, 1024))],
    ids=["shape0", "shape1", "dq-shape0", "dq-shape1"])
def test_ds_rounding_bounds_dk_agreement(grad, shape, seed):
    """Why the card holds dq and dk to 1e-2 per row and dv to 1e-3: s
    summed in another order (here in float64, then rounded to fp32, as a
    tensor-core kernel's sum differs from the plain fp32 matmul's) moves ds
    by an fp32 rounding, which carries some bf16(ds) to the neighbouring
    bf16 value, 2^-8 to 2^-7 away; a key row fed by few queries (dk), or a
    query row fed by few keys (dq), then moves by about that much. Without
    the bf16 rounding of ds the same change moves the gradient by less than
    1e-4 per row. Causal, d 64, as at the training shape. A dq row that
    sees one key is held absolutely (``_dq_row_errs``)."""
    bh, sq, sk = shape
    q, k, v, lse, dout, D = _inputs(bh, sq, sk, 64, 0, 0, True, seed=seed)
    s64 = tflash.causal_mask_scores(
        torch.einsum("bqd,bkd->bqk", q.double(), k.double()).float(), 0, 0)
    p = tflash.zero_masked(torch.exp(s64 - lse), s64)
    ds = p * (torch.einsum("bqd,bkd->bqk", dout, v.float()) - D)
    _, ds_ref = tflash._plain_ds(q, k, v, lse, dout, D, 0, 0, True)

    def errs(x, y):
        x, y = (ROUNDED_GRADS[grad](t, q, k) for t in (x, y))
        if grad == "dq":
            return _dq_row_errs(x, y, sk, 0, 0, True)
        return _row_errs(x, y)

    def rounded(x):
        return x.to(torch.bfloat16).float()

    assert errs(ds, ds_ref).max() <= 1e-4  # fp32 ds: no amplifier
    assert (rounded(ds) != rounded(ds_ref)).any()  # some entries flip
    assert errs(rounded(ds), rounded(ds_ref)).max() <= 1e-2
