"""Flash-attention block kernels (port of ``horovod_tpu/ops/flash.py``).

Three hand-written CUDA kernels for Hopper, one for each Pallas kernel of the
JAX package, under ``horovod_tpu_torch/csrc/``:

* ``flash_fwd`` (``flash_fwd.cu``) for ``_flash_kernel``: one online-softmax
  update of the carries ``(m, l, acc)`` by one K/V block (:func:`block_attend`);
* ``flash_bwd_dq`` (``flash_bwd_dq.cu``) for ``_flash_bwd_dq_kernel`` and
  ``flash_bwd_dkv`` (``flash_bwd_dkv.cu``) for ``_flash_bwd_dkv_kernel``: the
  block gradients against the saved log-sum-exp (:func:`flash_block_grads`).

Beside them are their plain PyTorch versions, :func:`attend_plain` and
:func:`plain_block_grads`, which take the Pallas kernels' precision: scores
and products accumulate in float32, and ``p`` (forward) and ``ds`` (dq and
dk products) are rounded to the input dtype first. A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches its kernel
or raises. Each launch adds one to its entry of :data:`launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # head dims the kernels are built for
_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches since the last reset_launch_counts(), by kernel.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def causal_mask_scores(s, qpos0, kpos0):
    """Mask future positions of a (bh|, sq, sk) score block to the NEG_INF
    sentinel. ``qpos0``/``kpos0`` are the integer global offsets of the
    blocks."""
    sq, sk = s.shape[-2], s.shape[-1]
    qpos = int(qpos0) + torch.arange(sq, device=s.device)
    kpos = int(kpos0) + torch.arange(sk, device=s.device)
    return s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)


def live_keys(sq, sk, qpos0, kpos0, causal, device=None):
    """The number of keys each of ``sq`` query rows takes part with, as an
    int64 (sq,) tensor: all ``sk``, or under causal masking those whose
    global position is not after the query's."""
    if not causal:
        return torch.full((sq,), sk, dtype=torch.int64, device=device)
    first = int(qpos0) - int(kpos0) + 1
    return (first + torch.arange(sq, device=device)).clamp(0, sk)


def zero_masked(p, s):
    """Zero softmax weights at sentinel-masked score positions, so that a
    fully masked row keeps ``l == 0`` whatever order blocks come in."""
    return p.masked_fill(s <= NEG_INF / 2, 0.0)


def _scores(q, k, qpos0, kpos0, causal):
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    return causal_mask_scores(s, qpos0, kpos0) if causal else s


def attend_plain(q, k, v, qpos0, kpos0, causal, m, l, acc):
    """Plain version of one block update (twin of the JAX ``_attend_jnp``,
    at the Pallas kernel's precision). Shapes as :func:`block_attend`."""
    s = _scores(q, k, qpos0, kpos0, causal)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    if causal:
        p = zero_masked(p, s)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1, keepdim=True)
    pv = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc * corr + pv


def _plain_ds(q, k, v, lse, dout, D, qpos0, kpos0, causal):
    """The normalized weights ``p`` and ``ds = p (dO . v^T - D)``."""
    s = _scores(q, k, qpos0, kpos0, causal)
    p = torch.exp(s - lse)
    if causal:
        p = zero_masked(p, s)
    dp = torch.einsum("bqd,bkd->bqk", dout, v.float())
    return p, p * (dp - D)


def plain_bwd_dq(q, k, v, lse, dout, D, qpos0, kpos0, causal):
    """Plain version of the dq kernel."""
    _, ds = _plain_ds(q, k, v, lse, dout, D, qpos0, kpos0, causal)
    return torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), k.float())


def plain_bwd_dkv(q, k, v, lse, dout, D, qpos0, kpos0, causal):
    """Plain version of the dk/dv kernel."""
    p, ds = _plain_ds(q, k, v, lse, dout, D, qpos0, kpos0, causal)
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), q.float())
    return dk, torch.einsum("bqk,bqd->bkd", p, dout)


def plain_block_grads(q, k, v, lse, dout, D, qpos0, kpos0, causal):
    """Plain version of :func:`flash_block_grads` (twin of the JAX
    ``jnp_block_grads``): ``(dq, dk, dv)`` in float32."""
    args = (q, k, v, lse, dout, D, qpos0, kpos0, causal)
    return (plain_bwd_dq(*args), *plain_bwd_dkv(*args))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q k v m l acc mo lo acco | bh sq sk d qpos0 kpos0 causal is_bf16 | stream
    "flash_fwd": [_P] * 9 + [_I] * 8 + [_P],
    # q k v lse D dout dq | ...
    "flash_bwd_dq": [_P] * 7 + [_I] * 8 + [_P],
    # q k v lse D dout dk dv | ...
    "flash_bwd_dkv": [_P] * 8 + [_I] * 8 + [_P],
}


def _entry(name: str):
    """The C entry ``hvd_<name>`` of kernel source ``name``."""
    lib = _build.load(name)
    fn = getattr(lib, f"hvd_{name}")
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _offset(x) -> int:
    x = int(x)
    if not -2**31 <= x < 2**31:
        raise ValueError(f"block offset {x} does not fit int32")
    return x


def _check_qkv(q, k, v, what: str) -> tuple[int, int, int, int]:
    if not (q.dim() == k.dim() == v.dim() == 3):
        raise ValueError(f"{what}: q, k, v must be (bh, s, d)")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != (bh, sk, d):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one dtype of {_DTYPES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} is not one of {HEAD_DIMS}")
    if sq < 1 or sk < 1:
        raise ValueError(f"{what}: empty block (sq={sq}, sk={sk})")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: q, k, v must be contiguous on one "
                             "device")
    return bh, sq, sk, d


def _check_f32(t, shape, device, what: str, name: str) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{what}: {name} must be contiguous float32 {tuple(shape)} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _on_cpu(*tensors) -> bool:
    """Whether every tensor lies on the CPU (then the plain version runs);
    raises for tensors that are neither all on the CPU nor all on CUDA."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return False
    raise ValueError(f"flash kernels take CPU or CUDA tensors, got {types}")


def _launch_fwd(q, k, v, qpos0, kpos0, causal, m, l, acc):
    bh, sq, sk, d = _check_qkv(q, k, v, "flash_fwd")
    for t, name, shape in ((m, "m", (bh, sq, 1)), (l, "l", (bh, sq, 1)),
                           (acc, "acc", (bh, sq, d))):
        _check_f32(t, shape, q.device, "flash_fwd", name)
    outs = (torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc))
    lib, fn = _entry("flash_fwd")
    with torch.cuda.device(q.device):
        status = fn(*(t.data_ptr() for t in (q, k, v, m, l, acc, *outs)),
                    bh, sq, sk, d, _offset(qpos0), _offset(kpos0),
                    int(bool(causal)), int(q.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "flash_fwd")
    launches["flash_fwd"] += 1
    return outs


def _check_grad_inputs(q, k, v, lse, dout, D, what):
    bh, sq, sk, d = _check_qkv(q, k, v, what)
    for t, name, shape in ((lse, "lse", (bh, sq, 1)), (D, "D", (bh, sq, 1)),
                           (dout, "dout", (bh, sq, d))):
        _check_f32(t, shape, q.device, what, name)
    return bh, sq, sk, d


def _launch_bwd_dq(q, k, v, lse, dout, D, qpos0, kpos0, causal):
    bh, sq, sk, d = _check_grad_inputs(q, k, v, lse, dout, D, "flash_bwd_dq")
    dq = torch.empty((bh, sq, d), dtype=torch.float32, device=q.device)
    lib, fn = _entry("flash_bwd_dq")
    with torch.cuda.device(q.device):
        status = fn(*(t.data_ptr() for t in (q, k, v, lse, D, dout, dq)),
                    bh, sq, sk, d, _offset(qpos0), _offset(kpos0),
                    int(bool(causal)), int(q.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def _launch_bwd_dkv(q, k, v, lse, dout, D, qpos0, kpos0, causal):
    bh, sq, sk, d = _check_grad_inputs(q, k, v, lse, dout, D,
                                       "flash_bwd_dkv")
    dk = torch.empty((bh, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    lib, fn = _entry("flash_bwd_dkv")
    with torch.cuda.device(q.device):
        status = fn(*(t.data_ptr() for t in (q, k, v, lse, D, dout, dk, dv)),
                    bh, sq, sk, d, _offset(qpos0), _offset(kpos0),
                    int(bool(causal)), int(q.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, status, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def block_attend(q, k, v, qpos0, kpos0, causal, m, l, acc):
    """One flash block update: returns the new ``(m, l, acc)`` carries.

    Layout: q (bh, sq, d) pre-scaled; k/v (bh, sk, d), bf16 or float32;
    m/l (bh, sq, 1) and acc (bh, sq, d) float32; ``qpos0``/``kpos0`` the
    int32 global token offsets of the blocks, for causal masking. The
    gradient is taken by ``_RingCore`` in ``parallel/sequence.py``,
    not through this function."""
    if _on_cpu(q, k, v, m, l, acc):
        return attend_plain(q, k, v, qpos0, kpos0, causal, m, l, acc)
    return _launch_fwd(q, k, v, qpos0, kpos0, causal, m, l, acc)


def flash_block_grads(q, k, v, lse, dout, D, qpos0, kpos0, causal):
    """Block gradients ``(dq, dk, dv)``, float32, of one K/V block against
    the full saved ``lse``. Shapes: q/dout (bh, sq, d); k/v (bh, sk, d);
    lse/D (bh, sq, 1) with ``D = rowsum(dout * out)``; dout, lse and D
    float32."""
    if _on_cpu(q, k, v, lse, dout, D):
        return plain_block_grads(q, k, v, lse, dout, D, qpos0, kpos0, causal)
    dq = _launch_bwd_dq(q, k, v, lse, dout, D, qpos0, kpos0, causal)
    dk, dv = _launch_bwd_dkv(q, k, v, lse, dout, D, qpos0, kpos0, causal)
    return dq, dk, dv
