"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a card; the
``world4`` tests (NCCL over four ranks, one card each) skip on a host with
fewer than four. The file imports nothing of JAX, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash
from horovod_tpu_torch.parallel import moe, sequence

REPO = Path(__file__).resolve().parent.parent
LAUNCH = [sys.executable, "-m", "horovod_tpu_torch.runner.launch"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _block(g, device, dtype, bh, sq, sk, d, qpos0, kpos0, causal, dv=None):
    """Seeded inputs whose lse and D are those of a real forward pass; v
    (and dout) ``dv`` wide, ``d`` unless given."""
    dv = d if dv is None else dv
    q, k, v = (torch.randn((bh, n, w), generator=g).to(device, dtype)
               for n, w in ((sq, d), (sk, d), (sk, dv)))
    q = (q.float() / d ** 0.5).to(dtype)
    m = torch.full((bh, sq, 1), flash.NEG_INF, device=device)
    l = torch.zeros((bh, sq, 1), device=device)
    acc = torch.zeros((bh, sq, dv), device=device)
    m, l, acc = flash.attend_plain(q, k, v, qpos0, kpos0, causal, m, l, acc)
    l_safe = l.clamp_min(1e-30)
    dout = torch.randn((bh, sq, dv), generator=g).to(device)
    D = (dout * (acc / l_safe)).sum(-1, keepdim=True)
    return q, k, v, m + torch.log(l_safe), dout, D


def _row_errs(x, y):
    """The error of each row (a d-vector) relative to that row's norm in
    the plain result ``y``."""
    return (x - y).norm(dim=-1) / y.norm(dim=-1).clamp_min(1e-30)


def _dq_row_errs(x, y, sq, sk, qpos0, kpos0, causal):
    """As ``_row_errs``, but absolute on the query rows that see exactly one
    key: their dq is 0 in exact arithmetic (the one softmax weight is 1
    whatever q is), and kernel and plain version compute fp32 noise of
    (dp - D) . k there."""
    one = flash.live_keys(sq, sk, qpos0, kpos0, causal, x.device) == 1
    return torch.where(one, (x - y).norm(dim=-1), _row_errs(x, y))


# Per-row relative limits. float32: the fp32 kernels sum in another order.
# bf16: acc / l, dq and dk hold a bf16 rounding (p, ds) that kernel and
# plain version may take to neighbouring values (2^-8 to 2^-7 apart) on a
# row fed by few entries: the tensor cores sum s = q . k^T in another order
# than the plain version's fp32 matmul; dv takes p and dO as bf16 pairs
# (about 16 bits each).
ROW_LIMITS = {
    torch.float32: {"acc / l": 1e-4, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4},
    torch.bfloat16: {"acc / l": 1e-2, "dq": 1e-2, "dk": 1e-2, "dv": 1e-3},
}
# bf16 dq and dk: a flipped bf16(ds) moves a query or key row by a bf16 step
# of one entry, and does so only on few rows, so nine rows in ten stay
# within this.
P90_LIMIT = 1e-4


KERNEL_SHAPES = [(2, 13, 11, 3, 0), (3, 130, 200, 0, 70), (2, 64, 64, 0, 0),
                 (1, 300, 40, 500, 0), (2, 63, 65, 0, 0), (2, 129, 127, 0, 0),
                 (1, 2047, 2049, 0, 0), (1, 300, 40, 0, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernels_match_plain(cuda_device, causal, d, shape, dtype, tol):
    """Each kernel against its plain version at ragged, offset and
    tile-edge shapes (one row short of, one row past, or inside a tile of
    the bf16 tensor-core kernels; fully masked rows; with causal masking,
    whole query tiles that see no key, whose plain dq is exactly 0), one
    launch each, from random incoming carries. m: rtol = atol = 1e-5 (a
    max of float32 dot products summed in another order); l: rtol 1e-4;
    acc / l and the gradients: float32 rtol = atol = 1e-4, bf16 2e-2 (p
    rounded to bf16 against the running, not the final, row max), and each
    row within ``ROW_LIMITS`` of its plain row, so that no tile can be
    wrong unseen (a dq row that sees one key: absolute, see
    ``_dq_row_errs``); bf16 dq's and dk's 90th-percentile rows within
    ``P90_LIMIT``."""
    _kernels_match_plain(cuda_device, causal, d, d, shape, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KERNEL_SHAPES + [(2, 1000, 1000, 0, 0)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_mla_kernels_match_plain(cuda_device, causal, shape):
    """K1-K3 at multi-head latent attention's widths, q and k 192, v 128
    (bf16, the one dtype they are built for), against the plain versions
    at the same shapes and to the same limits as the equal widths."""
    _kernels_match_plain(cuda_device, causal, 192, 128, shape,
                         torch.bfloat16, 2e-2)


def _kernels_match_plain(cuda_device, causal, d, dv, shape, dtype, tol):
    bh, sq, sk, qpos0, kpos0 = shape
    g = torch.Generator().manual_seed(sq * 1000 + sk)
    q, k, v, lse, dout, D = _block(g, cuda_device, dtype, bh, sq, sk, d,
                                   qpos0, kpos0, causal, dv)
    m0 = torch.randn((bh, sq, 1), generator=g).to(cuda_device)
    l0 = torch.rand((bh, sq, 1), generator=g).to(cuda_device)
    acc0 = torch.randn((bh, sq, dv), generator=g).to(cuda_device)
    before = dict(flash.launches)
    (m1, l1, a1) = flash.block_attend(q, k, v, qpos0, kpos0, causal, m0, l0,
                                      acc0)
    (m2, l2, a2) = flash.attend_plain(q, k, v, qpos0, kpos0, causal, m0, l0,
                                      acc0)
    close = lambda x, y, name, **tols: torch.testing.assert_close(
        x, y, msg=lambda default: f"{name}: {default}", **tols)
    close(m1, m2, "m", rtol=1e-5, atol=1e-5)
    close(l1, l2, "l", rtol=1e-4, atol=1e-6)
    # acc grows with l; its error is that of the normalized output acc / l
    close(a1 / l1, a2 / l2, "acc / l", rtol=tol, atol=tol)
    got = flash.flash_block_grads(q, k, v, lse, dout, D, qpos0, kpos0, causal)
    want = flash.plain_block_grads(q, k, v, lse, dout, D, qpos0, kpos0,
                                   causal)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        close(x, y, name, rtol=tol, atol=tol)
    row_errs = {"acc / l": _row_errs(a1 / l1, a2 / l2),
                "dq": _dq_row_errs(got[0], want[0], sq, sk, qpos0, kpos0,
                                   causal),
                "dk": _row_errs(got[1], want[1]),
                "dv": _row_errs(got[2], want[2])}
    over = {n: e.max().item() for n, e in row_errs.items()
            if not e.max() <= ROW_LIMITS[dtype][n]}
    assert not over, f"per-row relative errors over {ROW_LIMITS[dtype]}: {over}"
    if dtype == torch.bfloat16:
        for name in ("dq", "dk"):
            p90 = torch.quantile(row_errs[name].flatten(), 0.9)
            assert p90 <= P90_LIMIT, (
                f"{name}'s 90th-percentile row: {p90.item():.3g}")
    torch.cuda.synchronize()
    assert {n: flash.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", [(1, 100, 2), (2, 64, 4)])
def test_cuda_local_flash_matches_cpu(cuda_device, b, s, h):
    """``_local_flash`` forward and gradients on the card (the three
    kernels, through the autograd Function) against the same call on the
    CPU (the plain versions), float32 at head dim 64: atol 1e-4. Batch 1
    makes the (b, s, h, d) -> (b*h, s, d) reshape a strided view."""
    g = torch.Generator().manual_seed(b * 100 + s)
    q, k, v, ct = (torch.randn((b, s, h, 64), generator=g) for _ in range(4))
    outs, grads = [], []
    for dev in ("cpu", cuda_device):
        xs = [t.to(dev, copy=True).requires_grad_() for t in (q, k, v)]
        before = dict(flash.launches)
        out = sequence._local_flash(*xs, True)
        out.backward(ct.to(dev))
        outs.append(out.detach().cpu())
        grads.append([x.grad.cpu() for x in xs])
        launched = {n: flash.launches[n] - before[n] for n in before}
        assert set(launched.values()) == {0 if dev == "cpu" else 1}
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    for name, x, y in zip("qkv", grads[1], grads[0]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
def test_cuda_wrapper_rejects_unsupported_head_dim(cuda_device):
    """A CUDA tensor gets the kernel or an exception, never the plain path."""
    q = torch.zeros((1, 8, 32), device=cuda_device)
    carries = (torch.zeros((1, 8, 1), device=cuda_device),
               torch.zeros((1, 8, 1), device=cuda_device), q.clone())
    with pytest.raises(ValueError, match="head dim"):
        flash.block_attend(q, q, q, 0, 0, True, *carries)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_mla_widths_in_float32(cuda_device):
    """The 192 / 128 instantiation is bf16 only: float32 raises."""
    q = torch.zeros((1, 8, 192), device=cuda_device)
    v = torch.zeros((1, 8, 128), device=cuda_device)
    carries = (torch.zeros((1, 8, 1), device=cuda_device),
               torch.zeros((1, 8, 1), device=cuda_device), v.clone())
    with pytest.raises(TypeError, match="192/128"):
        flash.block_attend(q, q, v, 0, 0, True, *carries)


@pytest.mark.cuda
def test_cuda_local_flash_mla_widths_match_cpu(cuda_device):
    """``_local_flash`` with q and k 192 wide and v 128 (bf16 on the card:
    the three kernels through the autograd Function) against the plain
    versions on the CPU in float32 from the same bf16 values: outputs and
    gradients within 2e-2 of the largest entry (bf16 rounding of p, ds and
    the outputs)."""
    g = torch.Generator().manual_seed(192)
    b, s, h = 2, 300, 3
    q, k = (torch.randn((b, s, h, 192), generator=g) for _ in range(2))
    v, ct = (torch.randn((b, s, h, 128), generator=g) for _ in range(2))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    res = []
    for dev, dt in (("cpu", torch.float32), (cuda_device, torch.bfloat16)):
        xs = [t.to(dev, dt).requires_grad_() for t in (q, k, v)]
        out = sequence._local_flash(*xs, True)
        out.float().backward(ct.to(dev))
        res.append([out.detach().float().cpu()]
                   + [x.grad.float().cpu() for x in xs])
    for name, got, want in zip(("out", "dq", "dk", "dv"), res[1], res[0]):
        err = (got - want).abs().max() / want.abs().max()
        assert err <= 2e-2, f"{name}: {err.item():.3g}"


def _moe_case(seed, tokens=4096, d=2048, f=1408, n_expert=64, n_held=8):
    """Seeded inputs of the dropless layer at Moonlight's widths: bf16
    tokens and held experts' weights, float32 router logits that send
    nearly every token to expert 0 and none to expert 7 (the held
    experts are 0-7), and a float32 cotangent."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((tokens, d), generator=g).bfloat16()
    logits = torch.randn((tokens, n_expert), generator=g)
    logits[:, 0] += 3.0
    logits[:, 7] -= 30.0
    w_gu = (torch.randn((n_held, 2 * f, d), generator=g) / d ** 0.5).bfloat16()
    w_d = (torch.randn((n_held, d, f), generator=g) / f ** 0.5).bfloat16()
    return x, logits, w_gu, w_d, torch.randn((tokens, d), generator=g)


def _moe_grads(dev, x, logits, w_gu, w_d, ct, k=6):
    """The layer's output and the gradients of its four inputs on
    ``dev``."""
    leaves = [t.detach().to(dev, copy=True).requires_grad_()
              for t in (x, logits, w_gu, w_d)]
    xd, ld, gu, wd = leaves
    idx, w, _ = moe.route_sigmoid_top_k(
        ld, torch.zeros(ld.shape[-1], device=dev), k, 2.446)
    y = moe.held_experts(xd, idx, w, gu, wd, 0)
    y.float().backward(ct.to(dev))
    return [y.detach().float().cpu()] + [t.grad.float().cpu()
                                         for t in leaves]


@pytest.mark.cuda
def test_cuda_held_experts_match_cpu(cuda_device):
    """The dropless layer on the card (``torch._grouped_mm`` over the
    expert-sorted rows, bf16) against the same call on the CPU (its
    grouped GEMM, bf16), under forced imbalance: expert 0 takes nearly
    every token, expert 7 none. Output and the gradients of the tokens,
    the router logits and both expert weights within 2e-2 of the largest
    entry: bf16 products summed in another order."""
    case = _moe_case(1)
    want = _moe_grads("cpu", *case)
    got = _moe_grads(cuda_device, *case)
    for name, a, b in zip(("y", "dx", "dlogits", "dw_gate_up", "dw_down"),
                          got, want):
        err = (a - b).abs().max() / b.abs().max()
        assert err <= 2e-2, f"{name}: {err.item():.3g}"
    assert want[3][7].abs().max() == 0  # the expert no token picked


@pytest.mark.cuda
def test_cuda_held_experts_make_no_host_sync(cuda_device):
    """Routing, the sort, the offsets, the grouped GEMMs, the combine and
    the whole backward run with the card's sync debug mode at "error":
    nothing in the layer waits for the device, and the row tally stays on
    it."""
    case = _moe_case(2, tokens=2048)
    _moe_grads(cuda_device, *case)  # warm: first calls may load libraries
    leaves = [t.to(cuda_device, copy=True).requires_grad_()
              for t in case[:4]]
    bias = torch.zeros(64, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, w, _ = moe.route_sigmoid_top_k(leaves[1], bias, 6, 2.446)
        y = moe.held_experts(leaves[0], idx, w, leaves[2], leaves[3], 0,
                             layer="sync-check")
        y.float().backward(torch.ones_like(y, dtype=torch.float32))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    from horovod_tpu_torch import metrics
    metrics.snapshot()
    rows = {dict(k)["expert"]: v for k, v in
            metrics.MOE_EXPERT_ROWS.series().items()
            if dict(k)["layer"] == "sync-check"}
    assert sum(rows.values()) == (idx < 8).sum().item()


@pytest.mark.cuda
def test_cuda_resnet18_matches_cpu(cuda_device):
    """ResNet-18 at 224x224, one float32 training-mode step on the card
    (TF32 off) against the same module in float64 on the CPU from the same
    weights:
    ``testing.convnet_reference_errors`` (logits, every gradient, the
    running averages) within ``testing.REFERENCE_LIMITS``."""
    from horovod_tpu_torch import testing
    errs = testing.convnet_reference_errors("ResNet18", 224, cuda_device)
    limits = testing.REFERENCE_LIMITS
    over = {k: v for k, v in errs.items() if not v <= limits[k]}
    assert not over, f"over {limits}: {over}"
    assert torch.backends.cudnn.allow_tf32  # restored after the step


@pytest.mark.cuda
def test_cuda_inception_v3_float32_eval_matches_cpu(cuda_device):
    """Inception V3 at 299x299, one float32 eval-mode step on the card (TF32
    off) against float64 on the CPU: its float32 convolutions, pooling
    (average pools with counted padding) and their backward, where no batch
    moments make the gradients ill-conditioned, within
    ``testing.REFERENCE_LIMITS``."""
    from horovod_tpu_torch import testing
    errs = testing.convnet_reference_errors("InceptionV3", 299, cuda_device,
                                            torch.float32, train=False)
    limits = testing.REFERENCE_LIMITS
    over = {k: v for k, v in errs.items() if not v <= limits[k]}
    assert not over, f"over {limits}: {over}"


@pytest.mark.cuda
def test_cuda_avg_pool_same_backward_matches_cpu(cuda_device):
    """The port's 3x3 average pool with counted padding, backward on a
    channels-last float32 tensor on the card, against float64 on the CPU:
    dx within 1e-5 in relative norm (torch's own ``avg_pool2d`` there is
    wrong, which ``avg_pool_same`` avoids by pooling a contiguous copy)."""
    from horovod_tpu_torch import testing
    errs = testing.pooling_errors(cuda_device)
    assert errs["avg_pool_same"] <= 1e-5, errs


@pytest.fixture
def cuda_world(cuda_device):
    """An NCCL world of one rank in this process."""
    from horovod_tpu_torch import runtime
    runtime.init()
    yield cuda_device
    runtime.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sync_batch_norm_world1_equals_batch_norm(cuda_world, dtype):
    """At an NCCL world of one, ``SyncBatchNorm`` on the card is
    ``BatchNorm``, bitwise: output, dx, dscale, dbias and the running
    averages after one training-mode pass."""
    from horovod_tpu_torch.models import BatchNorm, SyncBatchNorm
    g = torch.Generator().manual_seed(0)
    x = (torch.randn((8, 6, 5, 3), generator=g) * 2 + 0.5).to(cuda_world,
                                                             dtype)
    ct = torch.randn((8, 6, 5, 3), generator=g).to(cuda_world)
    res = []
    for cls in (BatchNorm, SyncBatchNorm):
        norm = cls(6, dtype=dtype, device=cuda_world)
        xs = x.clone().requires_grad_()
        y = norm(xs)
        (y.float() * ct).sum().backward()
        res.append((y, xs.grad, norm.weight.grad, norm.bias.grad,
                    norm.running_mean, norm.running_var))
    for name, a, b in zip(("y", "dx", "dscale", "dbias", "mean", "var"),
                          *res):
        assert torch.equal(a, b), name


# Every distinct (n, c, h, w) that ResNet-50's 53 norms take at batch 256,
# 224 x 224 (``test_torch_sync_bn.py`` derives them from the model).
RESNET50_NORM_SHAPES = (
    (256, 64, 112, 112), (256, 64, 56, 56), (256, 128, 56, 56),
    (256, 256, 56, 56), (256, 128, 28, 28), (256, 256, 28, 28),
    (256, 512, 28, 28), (256, 256, 14, 14), (256, 512, 14, 14),
    (256, 1024, 14, 14), (256, 512, 7, 7), (256, 2048, 7, 7))

# The BatchNorm kernels against their plain versions, per element.
# y and dx: the kernels round every step as the plain torch ops do, except
# that bwd_dx fuses its multiply-adds; what differs before the last rounding
# is the order of the float32 sums behind the per-channel coefficients
# (a few float32 roundings of values of order 1, so under 1e-5), and a
# bf16 output may then round to the neighbouring bf16 value (at most 2^-7 of
# it). dweight and dbias: float32 sums of the same n terms in two orders,
# each within about (its chain of roundings) x 2^-24 of the terms' absolute
# sum; chains of a few hundred, whose errors mostly cancel, stay within
# 1e-5 of that sum. The running averages move by 1 - momentum = 0.1 of the
# batch moments, float32 sums of n values in two orders: within 1e-5 of
# E[x^2]. float64: the same arguments at 2^-53, and one float32 rounding of
# the parameters' gradients and the running averages.
BN_LIMITS = {torch.float32: {"rtol": 1e-5, "atol": 1e-5, "sums": 1e-5},
             torch.bfloat16: {"rtol": 2 ** -7, "atol": 1e-5, "sums": 1e-5},
             torch.float64: {"rtol": 1e-12, "atol": 1e-12, "sums": 1e-12}}


def _bn_case(shape, dtype, device, layout, seed):
    """Seeded x (about N(0.5, 2^2)) and dy (N(0, 1)) of ``shape`` in
    ``layout`` (``channels_last``, ``nchw`` or ``plain`` for a tensor of
    any rank as it comes), and a state (weight, bias, running averages)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=device) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=device).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    c = shape[1]
    state = {"weight": 1 + 0.1 * torch.randn(c, generator=g, device=device),
             "bias": 0.1 * torch.randn(c, generator=g, device=device),
             "running_mean": 0.1 * torch.randn(c, generator=g,
                                               device=device),
             "running_var": 1 + 0.1 * torch.randn(
                 c, generator=g, device=device).abs()}
    return x, dy, state


def _bn_run(x, dy, state, train, plain=False):
    """One pass of a ``BatchNorm`` from ``state`` through the kernels (or
    through the plain versions, on the same card): y, dx, dweight, dbias
    and the running averages after it."""
    from horovod_tpu_torch.models import BatchNorm
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    norm = BatchNorm(x.shape[1], dtype=x.dtype, device=x.device)
    norm.load_state_dict(state)
    norm.train(train)
    xs = x.detach().clone().requires_grad_()
    steps = sbn._steps
    if plain:
        sbn._steps = lambda t, dtype: sbn.PLAIN
    try:
        y = norm(xs)
        y.backward(dy)
    finally:
        sbn._steps = steps
    return {"y": y.detach(), "dx": xs.grad, "dweight": norm.weight.grad,
            "dbias": norm.bias.grad, "running_mean": norm.running_mean,
            "running_var": norm.running_var}


def _bn_hold(got, want, x, dy, state, train):
    """``got`` against ``want`` within ``BN_LIMITS``; raises naming the
    first quantity out of them."""
    lim = dict(BN_LIMITS[x.dtype])
    if x.dtype == torch.float64 and not train:
        # eval mode's coefficient rsqrt(var + eps) * weight: the plain
        # version takes it in the float32 running averages' dtype, as flax
        # does; the kernels in float64
        lim["rtol"] = lim["atol"] = 2 ** -22
    acc = torch.promote_types(x.dtype, torch.float32)
    dims = [0] + list(range(2, x.dim()))
    x32, dy32 = x.to(acc), dy.to(acc)
    mean = x32.mean(dims, keepdim=True)
    r = torch.rsqrt(x32.var(dims, unbiased=False) + 1e-5)
    if not train:
        mean = state["running_mean"].to(acc).view_as(mean)
        r = torch.rsqrt(state["running_var"].to(acc) + 1e-5)
    sums = {"dbias": dy32.abs().sum(dims),
            "dweight": (dy32 * (x32 - mean)).abs().sum(dims) * r}
    for k in ("y", "dx"):
        torch.testing.assert_close(
            got[k].to(acc), want[k].to(acc), rtol=lim["rtol"],
            atol=lim["atol"], msg=lambda m, k=k: f"{k}: {m}")
    # a float64 result is rounded to its float32 parameter or buffer last
    last = lambda t: torch.finfo(t.dtype).eps * t.abs().to(acc)
    for k, s in sums.items():
        err = (got[k] - want[k]).abs().to(acc)
        assert (err <= lim["sums"] * s + last(want[k])).all(), (
            f"{k}: {(err / s).max().item():.3g} of the terms' absolute sum")
    scale = x32.square().mean()
    for k in ("running_mean", "running_var"):
        # 0.9 ra + 0.1 batch: the plain version rounds 0.9 ra to the float32
        # buffer's dtype first, and the sum to it last, each within an eps
        # of the terms, whose sum may cancel far below them
        old = state[k].to(acc)
        terms = 0.9 * old.abs() + (want[k].to(acc) - 0.9 * old).abs()
        eps = torch.finfo(want[k].dtype).eps
        err = (got[k] - want[k]).abs().to(acc)
        assert (err <= lim["sums"] * scale + 2 * eps * terms).all(), (
            f"{k}: {err.max().item():.3g}")
        if not train:
            assert torch.equal(got[k], state[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", RESNET50_NORM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_batch_norm_kernels_match_plain(cuda_device, shape, dtype,
                                             layout, train):
    """The four BatchNorm kernels (``csrc/batch_norm.cu``) against their
    plain versions on the card, at every norm shape of ResNet-50 at batch
    256, bf16 and float32, channels-last (read as it lies) and NCHW (copied
    once to rows), training and eval mode: y, dx, dweight, dbias and the
    running averages within ``BN_LIMITS``; each kernel launched once (eval:
    no stats)."""
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    x, dy, state = _bn_case(shape, dtype, cuda_device, layout, sum(shape))
    sbn.reset_launch_counts()
    got = _bn_run(x, dy, state, train)
    assert sbn.launches == {"stats": int(train), "norm": 1, "bwd_reduce": 1,
                            "bwd_dx": 1}
    want = _bn_run(x, dy, state, train, plain=True)
    assert sbn.launches["norm"] == 1  # the plain run launched nothing
    _bn_hold(got, want, x, dy, state, train)
    # y lies as rows of C contiguous channels (dx reaches the leaf in the
    # leaf's own layout, by autograd's gradient layout contract)
    assert got["y"].movedim(1, -1).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape,dtype,layout", [
    ((1000, 6), torch.float32, "plain"),        # (n, C), C not of 16 B
    ((8, 6, 5, 3), torch.bfloat16, "nchw"),     # the world-1 test's input
    ((4, 24, 33), torch.bfloat16, "plain"),     # (n, C, L)
    ((64, 2048, 3, 3), torch.float32, "channels_last"),  # 8 slabs of 64
    ((32, 200, 9, 9), torch.bfloat16, "channels_last"),  # a ragged slab
    ((16, 64, 12, 12), torch.float64, "channels_last"),
    ((0, 8, 4, 4), torch.bfloat16, "channels_last")])     # no rows
def test_cuda_batch_norm_kernels_match_plain_at_odd_shapes(
        cuda_device, shape, dtype, layout, train):
    """The kernels against their plain versions where the vector loads do
    not fit (C not a multiple of 16 B: one element a thread), at other
    ranks, at channel counts that split into slabs, in float64, and on an
    empty batch (NaN moments, as torch's mean gives them)."""
    x, dy, state = _bn_case(shape, dtype, cuda_device, layout, 7)
    got = _bn_run(x, dy, state, train)
    want = _bn_run(x, dy, state, train, plain=True)
    if x.numel() == 0:
        for k in ("running_mean", "running_var", "dweight", "dbias"):
            torch.testing.assert_close(got[k], want[k], equal_nan=True)
        return
    _bn_hold(got, want, x, dy, state, train)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 64, 112, 112), (256, 2048, 7, 7)],
                         ids=["stem", "stage4"])
def test_cuda_batch_norm_kernels_are_deterministic(cuda_device, shape):
    """Two runs of the kernels on the same input are bitwise equal: the
    reductions use no float atomics."""
    x, dy, state = _bn_case(shape, torch.bfloat16, cuda_device,
                            "channels_last", 11)
    a = _bn_run(x, dy, state, True)
    b = _bn_run(x, dy, state, True)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_cuda_resnet50_step_launches_each_batch_norm_kernel_53_times(
        cuda_device):
    """One training step of the bf16 ResNet-50 on the card launches each
    BatchNorm kernel once a norm: 53 times."""
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.models import sync_batch_norm as sbn
    model = ResNet50(num_classes=1000, device=cuda_device)
    x = torch.randn((2, 3, 64, 64), device=cuda_device)
    sbn.reset_launch_counts()
    model(x).float().sum().backward()
    assert sbn.launches == dict.fromkeys(sbn.launches, 53)


@pytest.mark.cuda
def test_cuda_convnets_default_to_the_card(cuda_device):
    """A convnet or norm built with no ``device`` (and no ``init()``) lands
    on the card."""
    from horovod_tpu_torch.examples.mnist import ConvNet
    from horovod_tpu_torch.models import (VGG16, BatchNorm, InceptionV3,
                                          ResNet18)
    for module in (ResNet18(num_classes=10), InceptionV3(num_classes=10),
                   VGG16(num_classes=10, classifier_width=64, image_size=32),
                   BatchNorm(4), ConvNet()):
        devices = {t.device.type for t in module.state_dict().values()}
        assert devices == {"cuda"}, type(module).__name__


def _ring_patterns(n=4, seq=2048):
    """Every live (sq, sk, qpos0, kpos0) of rank n-1 of a causal ring of n
    over ``seq`` tokens and of rank 0 of a zigzag ring of n (the shapes
    ``chip_smoke.py`` runs at 16384 tokens, here at ``seq``)."""
    blk, c = seq // n, seq // (2 * n)
    ring = [(blk, blk, qp, kp)
            for step in sequence.ring_schedule(n - 1, n, blk, blk, True)
            for _, _, qp, kp in step]
    zig = [(c, c, qp, kp) for step in sequence.zigzag_schedule(0, n, c)
           for _, _, qp, kp in step]
    return ring + zig


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _ring_patterns(),
                         ids=lambda s: "sq{}-sk{}-q{}-k{}".format(*s))
def test_cuda_ring_pattern_kernels_match_plain(cuda_device, shape):
    """The blocks a ring and a zigzag ring of 4 launch, diagonal and fully
    past at offsets up to 1792, bh 4, d 64, bf16, causal, from zero
    carries: each row of acc / l, dq, dk and dv within ``ROW_LIMITS`` of
    its plain row, dq's and dk's 90th-percentile rows within
    ``P90_LIMIT``."""
    sq, sk, qpos0, kpos0 = shape
    g = torch.Generator().manual_seed(qpos0 * 7 + kpos0)
    q, k, v, lse, dout, D = _block(g, cuda_device, torch.bfloat16, 4, sq,
                                   sk, 64, qpos0, kpos0, True)
    carries = (torch.full((4, sq, 1), flash.NEG_INF, device=cuda_device),
               torch.zeros((4, sq, 1), device=cuda_device),
               torch.zeros((4, sq, 64), device=cuda_device))
    m1, l1, a1 = flash.block_attend(q, k, v, qpos0, kpos0, True, *carries)
    m2, l2, a2 = flash.attend_plain(q, k, v, qpos0, kpos0, True, *carries)
    got = flash.flash_block_grads(q, k, v, lse, dout, D, qpos0, kpos0, True)
    want = flash.plain_block_grads(q, k, v, lse, dout, D, qpos0, kpos0,
                                   True)
    rows = {"acc / l": _row_errs(a1 / l1, a2 / l2),
            "dq": _dq_row_errs(got[0], want[0], sq, sk, qpos0, kpos0, True),
            "dk": _row_errs(got[1], want[1]),
            "dv": _row_errs(got[2], want[2])}
    limits = ROW_LIMITS[torch.bfloat16]
    over = {n: e.max().item() for n, e in rows.items()
            if not e.max() <= limits[n]}
    assert not over, f"per-row relative errors over {limits}: {over}"
    for name in ("dq", "dk"):
        p90 = torch.quantile(rows[name].flatten(), 0.9)
        assert p90 <= P90_LIMIT, f"{name}'s 90th-percentile row: {p90:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("attn,per_layer", [("ring", 1), ("ring_zigzag", 3),
                                            ("ulysses", 1)])
def test_cuda_long_context_step_world1(cuda_world, attn, per_layer):
    """Two steps of the long-context twin at full width over 2048 tokens
    at an NCCL world of one: finite losses, and each kernel launched
    ``per_layer`` times a layer a step (the zigzag halves the block even at
    one rank: its diagonal halves and the past one)."""
    from horovod_tpu_torch.examples import long_context_lm as lc
    res, _ = lc.train(lc.parse_args(["--model", "full", "--attn", attn,
                                     "--seq-len", "2048", "--batch", "1",
                                     "--steps", "2"]))
    assert all(torch.isfinite(torch.tensor(res["losses"])))
    want = 4 * per_layer
    assert res["launches_per_step"] == [{n: want for n in flash.launches}] * 2


# --------------------------------------------------------------------------
# NCCL at a world of four: one card a rank (NCCL takes no two ranks on one
# card), so these run only on a host with four cards.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA cards: NCCL takes one card a rank")


@pytest.fixture(scope="module")
def nccl_attention(four_cards, tmp_path_factory):
    """Every rank's attention cases from one NCCL world of four."""
    from test_torch_world2 import run_world
    return run_world("_sequence_rank_on_card",
                     tmp_path_factory.mktemp("nccl_attention"), size=4,
                     module="test_torch_long_context")


# Each kernel's launches on rank r of n in each case: the causal contiguous
# ring skips the blocks in the future, the zigzag computes 2n + 1
# sub-blocks on every rank, Ulysses one local block.
CASE_LAUNCHES = {"ring_causal": lambda r, n: r + 1,
                 "ring_full": lambda r, n: n,
                 "zigzag": lambda r, n: 2 * n + 1,
                 "ulysses_causal": lambda r, n: 1,
                 "ulysses_full": lambda r, n: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASE_LAUNCHES))
def test_cuda_nccl_world4_attention_matches_one_card(nccl_attention,
                                                     cuda_device, case):
    """Ring (causal and not), zigzag ring and Ulysses over four cards
    (NCCL: the ring's ``batch_isend_irecv``, the zigzag's routing, the
    all-to-alls), float32 at head dim 64, 256 tokens a rank: the gathered
    output and q, k, v gradients of sum((out - tgt)^2) against the local
    flash path over the whole sequence on one card, rtol = atol = 1e-4
    (the float32 kernels over other blocks, summed in another order); each
    rank launched each kernel as often as its schedule says."""
    from test_torch_long_context import card_inputs
    inp = card_inputs(4)
    causal = case != "ring_full" and case != "ulysses_full"
    q, k, v = (torch.from_numpy(inp[x]).to(cuda_device).requires_grad_()
               for x in "qkv")
    out = sequence._local_flash(q, k, v, causal)
    ((out - torch.from_numpy(inp["tgt"]).to(cuda_device)) ** 2).sum(
        ).backward()
    want = {"out": out, "dq": q.grad, "dk": k.grad, "dv": v.grad}
    for key, ref in want.items():
        got = torch.from_numpy(np.concatenate(
            [r[f"{case}_{key}"] for r in nccl_attention], axis=1))
        torch.testing.assert_close(got, ref.detach().cpu(), rtol=1e-4,
                                   atol=1e-4, msg=lambda m: f"{key}: {m}")
    for r, res in enumerate(nccl_attention):
        assert res[f"{case}_launches"].tolist() == [
            CASE_LAUNCHES[case](r, 4)] * 3, f"rank {r}"


@pytest.mark.cuda
def test_cuda_nccl_world4_collectives_are_exact(four_cards, tmp_path):
    """``allgather`` (ragged, int32, 0-d, async), even and uneven
    ``alltoall``, ``reducescatter`` (SUM, AVERAGE, int32),
    ``broadcast_async``, the object collectives, and allreduce with scale
    factors (int32 promotes to float32), MIN, MAX, PRODUCT and bools (SUM
    and PRODUCT count in int32) over NCCL at a world of four, each against
    numpy on the same integer-valued inputs: bitwise; the error cases with
    the gloo world's text."""
    from test_torch_world2 import (A2AV_ROWS, ALLREDUCE_CASES, a2av_splits,
                                   collective_inputs, collective_objects,
                                   run_world)
    n = 4
    ranks = run_world("_collectives_rank_on_card", tmp_path, size=n)
    inp, smat = collective_inputs(n), a2av_splits(n)

    def chunk(x, j, parts):
        rows = len(x) // parts
        return x[j * rows:(j + 1) * rows]

    def same(got, want):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    gathered = [collective_objects(r)[1] for r in range(n)]
    for r, res in enumerate(ranks):
        for key in ("ag", "ag_int"):
            same(res[key], np.concatenate(inp[key]))
        same(res["ag_scalar"], np.stack(inp["ag_scalar"]))
        same(res["ag_async"], res["ag"])
        for key in ("a2a", "a2a_int"):
            same(res[key], np.concatenate([chunk(x, r, n) for x in inp[key]]))
        total = sum(inp["rs"])
        same(res["rs_sum"], chunk(total, r, n))
        same(res["rs_avg"], chunk(total, r, n) / np.float32(n))
        same(res["rs_int"], chunk(sum(inp["rs_int"]), r, n))
        starts = np.cumsum(smat, axis=1) - smat
        same(res["a2av"], np.concatenate(
            [inp["a2av"][j][starts[j, r]:starts[j, r] + smat[j, r]]
             for j in range(n)]))
        same(res["a2av_recv"], smat[:, r].astype(np.int32))
        same(res["bcast_async"], inp["a2a"][n - 1])
        assert str(res["err_a2a_rows"]) == (
            f"ValueError: alltoall dim0 ({2 * n + 1}) must be divisible by "
            f"process set size ({n})")
        assert str(res["err_a2av_sum"]) == (
            f"ValueError: sum of splits entries exceeds the first dimension "
            f"({A2AV_ROWS}) (reference operations.cc:1703-1707)")
        assert str(res["bcast_object"]) == repr(collective_objects(n - 1)[0])
        assert str(res["gather_object"]) == repr(gathered)
        assert bool(res["homogeneous"])
        for key, (src, op, kw) in ALLREDUCE_CASES.items():
            same(res[key], _numpy_allreduce(inp[src], op, n, **kw))
        assert str(res["err_rs_bool"]).startswith(
            "TypeError: add does not accept dtype bool")
    assert ranks[0]["polls"].tolist() == [False, True]


def _numpy_allreduce(xs, op, n, prescale_factor=1.0, postscale_factor=1.0):
    """The reference's allreduce of the ranks' arrays ``xs`` in numpy, with
    its dtypes: a scale factor makes an integer float32, a bool SUM or
    PRODUCT counts in int32, MIN and MAX of bools stay bool, and an
    AVERAGE of bools is a float32 share."""
    f32 = np.float32
    stack = np.stack(xs)
    if stack.dtype == bool and op not in ("Min", "Max"):
        stack = stack.astype(f32 if op == "Average" else np.int32)
    if prescale_factor != 1.0:
        stack = stack.astype(f32) * f32(prescale_factor)
    out = {"Sum": lambda: stack.sum(0, dtype=stack.dtype),
           "Average": lambda: stack.sum(0, dtype=stack.dtype) / f32(n),
           "Min": lambda: stack.min(0), "Max": lambda: stack.max(0),
           "Product": lambda: stack.prod(0, dtype=stack.dtype)}[op]()
    if postscale_factor != 1.0:
        out = out.astype(f32) * f32(postscale_factor)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["ring", "ring_zigzag", "ulysses"])
def test_cuda_nccl_world4_long_context_twin(four_cards, attn, tmp_path):
    """``python -m horovod_tpu_torch.examples.long_context_lm`` over four
    cards, 65536 tokens (16384 a rank) at full width for 3 steps: every
    rank exits 0, so the loss fell (the twin raises where it does not). A
    collective that hangs makes NCCL dump each rank's flight recorder under
    ``tmp_path``, which the failure prints (ROADMAP C3)."""
    from test_torch_long_context import twin
    logs = twin(4, ["--model", "full", "--attn", attn, "--seq-len",
                    "65536", "--batch", "1", "--steps", "3"],
                trace_dir=tmp_path)
    assert "attention over 4 ranks, seq=65536 (16384 tokens/rank)" in logs[0]
    assert "OK" in logs[0], logs[0]
    print(logs[0])


@pytest.mark.cuda
def test_cuda_nccl_world4_process_sets_are_exact(four_cards, tmp_path):
    """The sets [0, 2], [1, 2, 3], then [0, 1] and [2, 3] reducing at the
    same time, over NCCL groups at a world of four: allreduce (SUM, MIN,
    MAX, PRODUCT, int32), grouped allreduce, broadcast from a set's last
    member, ragged allgather, even alltoall and reducescatter, each against
    numpy on the members' integer-valued inputs, bitwise; a non-member
    raises."""
    from test_torch_process_sets import PSETS, pset_inputs
    from test_torch_world2 import run_world
    n = 4
    ranks = run_world("_process_sets_rank_on_card", tmp_path, size=n,
                      module="test_torch_process_sets")

    def same(got, want):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    for s, members in enumerate(PSETS[n]):
        inp, k = pset_inputs(n, s), len(members)
        x = np.stack(inp["x"])
        for r in range(n):
            res, pre = ranks[r], f"s{s}_"
            if r not in members:
                assert "is not a member" in str(res[pre + "err"])
                continue
            i = members.index(r)
            same(res[pre + "ar_sum"], x.sum(0))
            same(res[pre + "ar_min"], x.min(0))
            same(res[pre + "ar_max"], x.max(0))
            same(res[pre + "ar_prod"], np.stack(inp["small"]).prod(0))
            same(res[pre + "ar_int"], np.stack(inp["xi"]).sum(
                0, dtype=np.int32))
            same(res[pre + "grouped"], np.concatenate(
                [x.sum(0).ravel(),
                 np.stack(inp["xi"]).sum(0).astype(np.float32)]))
            same(res[pre + "bcast"], inp["x"][-1])
            same(res[pre + "bcast_async"], inp["xi"][-1])
            same(res[pre + "ag"], np.concatenate(inp["ag"]))
            rows = 2
            same(res[pre + "a2a"], np.concatenate(
                [a[i * rows:(i + 1) * rows] for a in inp["a2a"]]))
            same(res[pre + "rs_sum"],
                 sum(inp["rs"])[i * rows:(i + 1) * rows])
            same(res[pre + "bparams_p"], inp["p"][-1])
            assert str(res[pre + "objects"]) == repr([(m, s) for m in members])
            assert k == len(members)


@pytest.mark.cuda
def test_cuda_nccl_world4_backward_passes_per_step(four_cards, cuda_device,
                                                   tmp_path):
    """The hook-driven optimizer over NCCL at a world of four with
    ``backward_passes_per_step=2``: each k-th pass reduces the mean of the
    two passes over the four ranks, and Adam steps as it does on one card
    given that mean (rtol 1e-6; the parameters are unchanged on the passes
    that fold)."""
    from test_torch_optimizer import (MS_LR, SHAPES, ms_grads, ms_params,
                                      run_world)
    ranks = run_world("_multisteps_rank_on_card", tmp_path, size=4,
                      module="test_torch_optimizer")
    grads = ms_grads(2, 4)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v).to(cuda_device))
          for k, v in ms_params().items()}
    opt = torch.optim.Adam(ps.values(), lr=MS_LR)
    before = ms_params()
    for i in range(4):
        if i % 2 == 1:
            for k in SHAPES:
                mean = np.mean([grads[j][r][k] for j in (i - 1, i)
                                for r in range(4)], axis=0)
                ps[k].grad = torch.from_numpy(mean).to(cuda_device)
                for res in ranks:
                    np.testing.assert_allclose(res[f"ms2_grad{i}_{k}"], mean,
                                               rtol=1e-6, atol=1e-7)
            opt.step()
        for res in ranks:
            for k in SHAPES:
                want = (ps[k].detach().cpu().numpy() if i % 2 else before[k])
                np.testing.assert_allclose(res[f"ms2_pass{i}_{k}"], want,
                                           rtol=1e-6, atol=1e-7)
        if i % 2:
            before = {k: p.detach().cpu().numpy() for k, p in ps.items()}
    for res in ranks:
        assert res["ms2_in_backward"].tolist() == [1, 1]


@pytest.mark.cuda
def test_cuda_nccl_world4_trainer_overlap(four_cards, tmp_path):
    """Four cards train the full-width TransformerLM data-parallel (8 x
    2048 tokens a card); every rank's loss is finite, and rank 0's profiled
    step says whether the first gradient bucket's NCCL kernel started
    before the backward pass's last kernel ended. That reading is printed
    and recorded, not held to a limit."""
    from test_torch_optimizer import run_world
    ranks = run_world("_overlap_rank_on_card", tmp_path, size=4,
                      module="test_torch_optimizer")
    for r, res in enumerate(ranks):
        assert np.isfinite(res["losses"]).all(), r
        print(f"rank {r}: step {float(res['step_ms']):.2f} ms, "
              f"{int(res['buckets'])} buckets, started in backward "
              f"{res['started_in_backward'].tolist()}, losses "
              f"{res['losses'].tolist()}")
    print(f"rank 0 overlap: {ranks[0]['overlap']}")


@pytest.mark.cuda
def test_cuda_nccl_world4_two_level_trainer_overlap(four_cards, tmp_path):
    """The trainer of :func:`test_cuda_nccl_world4_trainer_overlap` with
    its buckets reduced two-level (``HVD_HIERARCHICAL_ALLREDUCE``, two
    nodes of two): the losses are finite, a bucket starts during the
    backward pass on every rank, and the step time and rank 0's profiled
    step (the backward pass's last kernel against the NCCL kernels) are
    printed: the steps run on a side stream, so the backward pass does
    not wait for them."""
    from test_torch_optimizer import run_world
    ranks = run_world("_overlap_rank_on_card", tmp_path, size=4,
                      module="test_torch_optimizer",
                      env={"LOCAL_WORLD_SIZE": "2",
                           "HVD_HIERARCHICAL_ALLREDUCE": "1"})
    for r, res in enumerate(ranks):
        assert np.isfinite(res["losses"]).all(), r
        assert min(res["started_in_backward"]) >= 1, r
        print(f"rank {r}: step {float(res['step_ms']):.2f} ms, "
              f"{int(res['buckets'])} buckets, started in backward "
              f"{res['started_in_backward'].tolist()}")
    print(f"rank 0 overlap: {ranks[0]['overlap']}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_nccl_world4_sync_batch_norm_matches_one_card(
        four_cards, cuda_device, tmp_path_factory, dtype):
    """``SyncBatchNorm`` over NCCL at a world of four, each card with a
    quarter of the batch, against ``BatchNorm`` on one card over the whole
    batch: output and dx per quarter, the running averages on every rank,
    and dscale and dbias summed over the ranks (each rank's are its
    quarter's share, which the gradient sync adds up) (float32 rtol 1e-5
    atol 1e-5, running averages 1e-6/1e-7; bf16 output and dx 1e-2, dscale
    and dbias 1e-3, running averages 1e-5/1e-6)."""
    from horovod_tpu_torch.models import BatchNorm
    from test_torch_world2 import (BN_SHAPE, bn_inputs, bn_step,
                                   run_world)
    ranks = _sync_bn_world4(tmp_path_factory)
    inp = bn_inputs()
    x = torch.from_numpy(inp["x"]).to(cuda_device, getattr(torch, dtype))
    want = bn_step(BatchNorm(BN_SHAPE[-1], dtype=x.dtype,
                             device=cuda_device), x, inp["ct"], inp)
    tols = {"float32": {"y": 1e-5, "dx": 1e-5, "dscale": 1e-5,
                        "dbias": 1e-5, "mean": 1e-6, "var": 1e-6},
            "bfloat16": {"y": 1e-2, "dx": 1e-2, "dscale": 1e-3,
                         "dbias": 1e-3, "mean": 1e-5, "var": 1e-5}}[dtype]
    quarter = BN_SHAPE[0] // 4
    for r, res in enumerate(ranks):
        mine = slice(r * quarter, (r + 1) * quarter)
        for k, tol in tols.items():
            if k in ("dscale", "dbias"):
                got = sum(other[f"{dtype}_{k}"] for other in ranks)
            else:
                got = res[f"{dtype}_{k}"]
            ref = want[k][mine] if k in ("y", "dx") else want[k]
            atol = tol / 10 if k in ("mean", "var") else tol
            np.testing.assert_allclose(got, ref, rtol=tol, atol=atol,
                                       err_msg=f"rank {r} {k}")


_SYNC_BN_WORLD4 = {}


def _sync_bn_world4(tmp_path_factory):
    """Every rank's SyncBatchNorm results from one NCCL world of four, run
    once for both dtypes."""
    if not _SYNC_BN_WORLD4:
        from test_torch_world2 import run_world
        _SYNC_BN_WORLD4["ranks"] = run_world(
            "_sync_bn_rank_on_card", tmp_path_factory.mktemp("sync_bn4"),
            size=4)
    return _SYNC_BN_WORLD4["ranks"]


# --------------------------------------------------------------------------
# expert and pipeline parallelism and the two-level sync on four cards
# --------------------------------------------------------------------------

# The four-card MoE run against one card on the same weights, at every 64th
# position of each sequence: the mean absolute difference of the logits,
# and the share of positions whose largest difference stays within
# MOE_MAX_ABS (bf16 compute: a token whose router logits nearly tie may go
# to another expert when its activations differ by a rounding).
MOE_MEAN_ABS, MOE_MAX_ABS, MOE_WITHIN_SHARE = 1e-2, 0.25, 0.99


@pytest.mark.cuda
def test_cuda_nccl_world4_moe_transformer_matches_one_card(
        four_cards, cuda_device, tmp_path):
    """The full-width MoE TransformerLM over four cards (``moe_experts=4``,
    one expert a card, 2 x 2048 tokens a card, capacity factor 4 so that
    nothing drops): its first step's logits against one card running the
    same function (``test_torch_moe.DenseMoE``) on the four batches at once,
    within ``MOE_MEAN_ABS`` / ``MOE_MAX_ABS`` / ``MOE_WITHIN_SHARE``; the
    loss falls over 4 Adam steps, the flash kernels ran 4 times a step on
    every card, and rank 0's profiled step prints the all-to-all's share of
    its device time."""
    from test_torch_moe import (CARD_POSITIONS, CARD_STEPS, card_tokens,
                                one_card_moe_logits)
    from test_torch_world2 import run_world
    ranks = run_world("_moe_full_rank_on_card", tmp_path, size=4,
                      module="test_torch_moe")
    state = torch.load(tmp_path / "moe_weights.pt")
    tokens = torch.from_numpy(np.concatenate(
        [card_tokens(r) for r in range(4)])).to(cuda_device)
    want = one_card_moe_logits(state, tokens, cuda_device)[
        :, CARD_POSITIONS].cpu().numpy()
    got = np.concatenate([res["logits0"] for res in ranks])
    diff = np.abs(got - want)
    within = float((diff.max(-1) <= MOE_MAX_ABS).mean())
    wall, busy, nccl = ranks[0]["profile_ms"]
    print(f"four-card MoE: logits against one card: mean abs "
          f"{diff.mean():.3g}, max abs {diff.max():.3g}, positions within "
          f"{MOE_MAX_ABS}: {within:.4f}; losses {ranks[0]['losses']}; step "
          f"{1e3 * np.mean(ranks[0]['step_s'][1:]):.1f} ms; rank 0's "
          f"profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"NCCL {nccl:.2f} ms ({100 * nccl / busy:.1f} % of busy)")
    assert diff.mean() <= MOE_MEAN_ABS
    assert within >= MOE_WITHIN_SHARE
    for res in ranks:
        losses = res["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert res["launches"].tolist() == [4 * CARD_STEPS] * 3


def _twin_world4(module: str, argv: list, tmp_path, env=None,
                 kv: bool = False) -> list:
    from test_torch_world2 import spawn_world
    import sys
    return spawn_world(lambda rank: [sys.executable, "-m", module, *argv], 4,
                       env=env, trace_dir=tmp_path, kv=kv)


@pytest.mark.cuda
def test_cuda_nccl_world4_moe_twin(four_cards, tmp_path):
    """``python -m horovod_tpu_torch.examples.moe --model full`` over four
    cards (d_model 512, expert hidden 2048, 16384 tokens a card, bf16): every
    rank exits 0, so the loss fell."""
    logs = _twin_world4("horovod_tpu_torch.examples.moe",
                        ["--model", "full", "--steps", "10"], tmp_path)
    assert "MoE: 4 experts over 4 ranks" in logs[0] and "OK" in logs[0]
    print(logs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("pp", [4, 2])
def test_cuda_nccl_world4_pipeline_twin(four_cards, pp, tmp_path):
    """``python -m horovod_tpu_torch.examples.pipeline_train --model full``
    over four cards at pp 4 and at dp 2 x pp 2 (4 microbatches, 8 x 2048
    tokens a replica, bf16): every rank exits 0, so the loss fell."""
    logs = _twin_world4("horovod_tpu_torch.examples.pipeline_train",
                        ["--model", "full", "--pp", str(pp), "--steps", "8"],
                        tmp_path)
    assert f"pp={pp} dp={4 // pp}" in logs[0] and "OK" in logs[0]
    print(logs[0])


@pytest.mark.cuda
def test_cuda_nccl_world4_two_level_is_exact(four_cards, tmp_path):
    """Over NCCL in two nodes of two (``LOCAL_WORLD_SIZE=2``): the
    two-level allreduce (routed and explicit) bitwise the flat one in the
    exactness domain and within rtol 1e-6 on Gaussian inputs, the two-level
    allgather in rank order, ``sync_gradients`` over dp x dp and dp x ep
    bitwise the flat sync of the data ranks, and
    ``DistributedOptimizer(mesh_spec=)`` over dp 2 x ep 2 stepping as the
    flat sync over the world: the checks of
    ``tests/test_torch_hierarchical.py``, on the card."""
    import test_torch_hierarchical as th
    from test_torch_world2 import run_world
    ranks = run_world("_hier_rank_on_card", tmp_path, size=4,
                      module="test_torch_hierarchical",
                      env={"LOCAL_WORLD_SIZE": "2"})
    for data in ("exact", "gauss"):
        for case in th.CASES:
            th.test_two_level_allreduce_matches_flat(ranks, data, case)
    th.test_two_level_leaves_other_ops_and_sets_flat(ranks)
    th.test_two_level_allgather_in_rank_order(ranks)
    for layout in ("dcn2_ici2", "ep_across", "ep_within"):
        th.test_sync_gradients_equals_pure_dp(ranks, layout)
    th.test_optimizer_mesh_spec_steps_as_the_data_set(ranks)


@pytest.mark.cuda
def test_cuda_nccl_world4_flight_recorder_dumps_a_hang(four_cards, tmp_path):
    """The diagnostics of ROADMAP C3: in a world of four, rank 0 enters an
    allreduce alone; after ``HVD_PROCESS_GROUP_TIMEOUT`` (15 s here) NCCL's
    watchdog dumps rank 0's flight recorder under ``tmp_path`` and aborts
    it, and ``spawn_world``'s failure prints the dump: the allreduce that
    hung, with its sequence number and state."""
    import sys
    from test_torch_world2 import spawn_world
    code = "import test_torch_world2 as w; w._hang_rank_on_card('')"
    with pytest.raises(AssertionError) as failure:
        spawn_world(lambda rank: [sys.executable, "-c", code], 4,
                    env={"HVD_PROCESS_GROUP_TIMEOUT": "15"},
                    trace_dir=tmp_path)
    msg = str(failure.value)
    print(msg[-6000:])
    assert "rank 0 failed" in msg
    assert "NCCL flight records" in msg and "nccl_trace_rank_0" in msg
    assert "all_reduce" in msg


@pytest.mark.cuda
def test_cuda_nccl_world4_moe_alltoall_and_pipeline_match_cpu(
        four_cards, tmp_path):
    """Over NCCL at a world of four, the paths the full-width runs do not
    take: ``moe_alltoall`` with k 1 and 2, with nothing dropped and with
    the capacity forced to 2, against the same ranks' gloo run on the host
    (outputs and the load-balance loss rtol 1e-5 atol 1e-5, gradients rtol
    1e-4 atol 1e-6; float32, TF32 off by default); ``pipeline_apply`` at pp
    4 with 1 and 4 microbatches, ``remat`` on and off, against the stages
    applied in sequence on the host (outputs rtol 1e-5 atol 1e-6, stage
    gradients rtol 1e-4 atol 1e-6, the input cotangent rtol 1e-4 atol 1e-7
    and bitwise the same on every stage)."""
    import test_torch_pipeline as tp
    from test_torch_moe import CAPACITIES, KS
    from test_torch_world2 import run_world
    card = run_world("_alltoall_rank_on_card", tmp_path / "moe_card", size=4,
                     module="test_torch_moe")
    host = run_world("_alltoall_rank", tmp_path / "moe_cpu", size=4,
                     module="test_torch_moe")
    for r, (got, want) in enumerate(zip(card, host)):
        for k in KS:
            for case in CAPACITIES:
                for name in ("y", "aux", "gx", "glogits", "gw"):
                    key = f"k{k}_{case}_{name}"
                    tol = (dict(rtol=1e-5, atol=1e-5) if name in ("y", "aux")
                           else dict(rtol=1e-4, atol=1e-6))
                    np.testing.assert_allclose(got[key], want[key], **tol,
                                               err_msg=f"rank {r} {key}")
    ranks = run_world("_pipeline_rank_on_card", tmp_path / "pipe", size=4,
                      module="test_torch_pipeline")
    out, gw, gb, gx = tp._sequential(4)
    for m in tp.N_MICRO:
        for remat in tp.REMAT:
            key = f"m{m}_remat{int(remat)}_"
            for r, res in enumerate(ranks):
                np.testing.assert_allclose(res[key + "out"], out, rtol=1e-5,
                                           atol=1e-6)
                np.testing.assert_allclose(res[key + "gw"], gw[r],
                                           rtol=1e-4, atol=1e-6)
                np.testing.assert_allclose(res[key + "gb"], gb[r],
                                           rtol=1e-4, atol=1e-6)
                np.testing.assert_allclose(res[key + "gx"], gx, rtol=1e-4,
                                           atol=1e-7)
                np.testing.assert_array_equal(res[key + "gx"],
                                              ranks[0][key + "gx"])


# --------------------------------------------------------------------------
# Adasum and the negotiation service over four cards
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 3])
def test_cuda_nccl_world4_adasum_matches_numpy(four_cards, n, tmp_path):
    """``adasum_allreduce`` of a 2**20-element float32 vector a card over
    NCCL at 4 ranks and at 3 (on three of the cards: the fold of the
    tail), against the float64 numpy model, rtol 1e-5 atol 1e-6 as on the
    CPU; at 4 ranks in two nodes of two, the two-level Adasum against the
    model's Adasum of the two nodes' sums."""
    from test_torch_adasum import CARD_LEN, np_adasum, vec
    from test_torch_world2 import run_world
    env = {"LOCAL_WORLD_SIZE": "2"} if n == 4 else {
        "CUDA_VISIBLE_DEVICES": "0,1,2"}
    ranks = run_world("_adasum_rank_on_card", tmp_path, size=n,
                      module="test_torch_adasum", env=env)
    vecs = [vec(r, n=CARD_LEN) for r in range(n)]
    want = np_adasum(vecs)
    for res in ranks:
        np.testing.assert_allclose(res["flat"], want, rtol=1e-5, atol=1e-6)
    if n == 4:
        nodes = np_adasum([vecs[0] + vecs[1], vecs[2] + vecs[3]])
        for res in ranks:
            np.testing.assert_allclose(res["two"], nodes, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.cuda
def test_cuda_nccl_world4_adasum_trainer(four_cards, tmp_path):
    """The full-width trainer over four cards with ``op=Average`` and then
    ``op=Adasum`` from the same weights, in one world: the Adasum losses
    fall, every step starts a bucket in the backward pass, and rank 0's
    profiled Adasum step shows the first NCCL kernel starting before the
    backward pass's last kernel ended. Both step times are printed."""
    from test_torch_world2 import run_world
    ranks = run_world("_adasum_trainer_rank_on_card", tmp_path, size=4,
                      module="test_torch_adasum")
    for r, res in enumerate(ranks):
        losses = res["adasum_losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0], r
        assert min(res["adasum_in_backward"]) >= 1, r
        print(f"rank {r}: step Average {float(res['average_step_ms']):.2f} "
              f"ms, Adasum {float(res['adasum_step_ms']):.2f} ms; Adasum "
              f"losses {losses.tolist()}; started in backward "
              f"{res['adasum_in_backward'].tolist()}")
    print(f"rank 0 Adasum overlap: {ranks[0]['overlap_report']}")
    assert bool(ranks[0]["overlap"])


@pytest.mark.cuda
def test_cuda_nccl_world4_negotiated_trainer_with_join(four_cards, tmp_path):
    """Four cards under the KV negotiation service: named allreduces in
    different orders complete, a shape mismatch raises on all four ranks,
    and the full-width trainer with uneven data (3, 1, 2 and 0 extra
    batches) ends in ``join`` and ``broadcast_parameters`` from the last
    rank to join, after which every rank holds the same parameters. The
    step time and the negotiation rounds a step are printed."""
    from test_torch_world2 import run_world
    ranks = run_world("_service_rank_on_card", tmp_path, size=4,
                      module="test_torch_negotiation", kv=True)
    for r, res in enumerate(ranks):
        for i, nm in enumerate("abc"):
            np.testing.assert_array_equal(
                res[f"ooo_{nm}"], np.full(1 << 16, float(6 + 4 * i)))
        assert str(res["mismatch"]).startswith("HorovodCollectiveError"), r
        assert np.isfinite(res["losses"]).all(), r
        assert int(res["last"]) == 0, r
        np.testing.assert_array_equal(res["checksum"], ranks[0]["checksum"])
        print(f"rank {r}: step {float(res['step_ms']):.2f} ms under the "
              f"service, {float(res['rounds_per_step']):.1f} busy rounds a "
              f"step of {float(res['round_ms']):.2f} ms, "
              f"{int(res['buckets'])} buckets; losses "
              f"{res['losses'].tolist()}")


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["ulysses"])
def test_cuda_nccl_world4_long_context_twin_negotiated(four_cards, attn,
                                                       tmp_path):
    """The long-context twin of :func:`test_cuda_nccl_world4_long_context_
    twin` under the KV negotiation service: its gradient buckets
    negotiate and share the world's communicator with the sequence
    exchanges, which do not (ROADMAP C3's loop runs this one)."""
    from test_torch_long_context import twin
    logs = twin(4, ["--model", "full", "--attn", attn, "--seq-len",
                    "65536", "--batch", "1", "--steps", "3"],
                trace_dir=tmp_path, kv=True)
    assert "OK" in logs[0], logs[0]
    print(logs[0])


@pytest.mark.cuda
def test_cuda_nccl_world4_moe_transformer_negotiated(four_cards, tmp_path):
    """The four-card MoE TransformerLM of :func:`test_cuda_nccl_world4_moe_
    transformer_matches_one_card` under the KV negotiation service: its
    gradient buckets negotiate beside the MoE all-to-alls, which do not;
    the loss falls on every card and the flash kernels ran 4 times a
    step (ROADMAP C3)."""
    from test_torch_moe import CARD_STEPS
    from test_torch_world2 import run_world
    ranks = run_world("_moe_full_rank_on_card", tmp_path, size=4,
                      module="test_torch_moe", kv=True)
    for res in ranks:
        losses = res["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        assert res["launches"].tolist() == [4 * CARD_STEPS] * 3
    print(f"four-card MoE under the service: losses "
          f"{ranks[0]['losses']}; step "
          f"{1e3 * np.mean(ranks[0]['step_s'][1:]):.1f} ms")


@pytest.mark.cuda
def test_cuda_nccl_world4_moe_twin_negotiated(four_cards, tmp_path):
    """The MoE twin of :func:`test_cuda_nccl_world4_moe_twin` under the KV
    negotiation service."""
    logs = _twin_world4("horovod_tpu_torch.examples.moe",
                        ["--model", "full", "--steps", "10"], tmp_path,
                        kv=True)
    assert "MoE: 4 experts over 4 ranks" in logs[0] and "OK" in logs[0]
    print(logs[0])


@pytest.mark.cuda
def test_cuda_nccl_world4_response_cache(four_cards, tmp_path):
    """Four cards under the KV service with ``HVD_RESPONSE_CACHE=1``: the
    served-traffic loop of ``test_torch_negotiation._cache_loop`` (named
    allreduces and broadcasts served from the cache, interleaved with
    negotiated allgathers, waited for in another order on each rank)
    gives the numpy results; served calls take no busy round; every
    rank's conformance trace diffs clean with ``tools.hvdtrace``. Prints
    the time of a served named allreduce against an unnegotiated one."""
    import json
    import subprocess
    import sys

    from test_torch_negotiation import CACHE_ITERS, CACHE_ROOT, cache_inputs
    from test_torch_world2 import REPO, run_world
    env = {"HVD_RESPONSE_CACHE": "1", "HVD_CONFORMANCE": "1",
           "HVD_CONFORMANCE_DIR": str(tmp_path / "traces")}
    ranks = run_world("_cache_rank_on_card", tmp_path, size=4,
                      module="test_torch_negotiation", env=env, kv=True)
    for it in range(CACHE_ITERS):
        x = cache_inputs(4, it)
        want = {"a": sum(x["a"]), "g": np.concatenate(x["g"]),
                "b": x["b"][CACHE_ROOT], "c": sum(x["c"]) / 4}
        for res in ranks:
            for k, v in want.items():
                np.testing.assert_array_equal(res[f"{k}{it}"], v)
    for r, res in enumerate(ranks):
        assert res["served"].tolist() == [0, 0] + [3] * (CACHE_ITERS - 2)
        assert float(res["served_rounds"]) == 0.0
        np.testing.assert_array_equal(res["served_sum"], np.full(4, 4.0))
        print(f"rank {r}: served named allreduce of 256 KiB "
              f"{float(res['served_ms']):.3f} ms a call (0 rounds), "
              f"unnegotiated {float(res['plain_ms']):.3f} ms; loop busy "
              f"rounds a step {res['rounds'].tolist()}; "
              f"{json.loads(str(res['stats']))}")
    out = subprocess.run([sys.executable, "-m", "tools.hvdtrace",
                          str(tmp_path / "traces")], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "clean (4 traces" in out.stdout, (
        out.stdout + out.stderr)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [None, "2"], ids=["flat", "g2"])
def test_cuda_nccl_world4_hier_negotiation_trainer(four_cards, group,
                                                   tmp_path):
    """The negotiated trainer of :func:`test_cuda_nccl_world4_negotiated_
    trainer_with_join`, flat and with leader groups of two
    (``HVD_NEGOTIATION_GROUP_SIZE=2``: member -> leader -> cross-leader ->
    fan-down), in one call so that their step and round times compare."""
    from test_torch_world2 import run_world
    env = {"HVD_NEGOTIATION_GROUP_SIZE": group} if group else {}
    ranks = run_world("_service_rank_on_card", tmp_path, size=4,
                      module="test_torch_negotiation", env=env, kv=True)
    for r, res in enumerate(ranks):
        assert str(res["transport"]) == ("HierarchicalTransport" if group
                                         else "KVTransport")
        assert np.isfinite(res["losses"]).all(), r
        assert int(res["last"]) == 0, r
        np.testing.assert_array_equal(res["checksum"], ranks[0]["checksum"])
        print(f"{group or 'flat'} rank {r}: step {float(res['step_ms']):.2f}"
              f" ms under the service, {float(res['rounds_per_step']):.1f} "
              f"busy rounds a step of {float(res['round_ms']):.2f} ms")


@pytest.mark.cuda
def test_cuda_nccl_world4_watchdog_names_a_dead_rank(four_cards, tmp_path):
    """Rank 1 of four exits at its sixth negotiated call
    (``HVD_FAULT_SPEC``); the three others raise ``PeerFailureError``
    naming it within ``HVD_HEALTH_TIMEOUT`` + 5 s."""
    from test_torch_world2 import run_world
    env = {"HVD_FAULT_SPEC": "svc.submit:crash:rank=1:after=5",
           "HVD_HEALTH_INTERVAL": "0.5", "HVD_HEALTH_TIMEOUT": "3"}
    ranks = run_world("_watchdog_rank_on_card", tmp_path, size=4,
                      module="test_torch_negotiation", env=env, kv=True,
                      exit_codes={1: 1})
    for r in (0, 2, 3):
        res = ranks[r]
        assert (int(res["failed_at"]), int(res["dead_rank"])) == (5, 1)
        assert float(res["seconds"]) < 8.0
        print(f"rank {r}: {str(res['error'])} after "
              f"{float(res['seconds']):.2f} s")


@pytest.mark.cuda
def test_cuda_nccl_world4_timeline_files(four_cards, tmp_path):
    """``HVD_TIMELINE`` at four cards: one file a rank, each with a
    NEGOTIATE range and an op range for every named collective."""
    import json

    from test_torch_negotiation import TIMELINE_NAMES
    from test_torch_world2 import run_world
    env = {"HVD_TIMELINE": str(tmp_path / "tl.json")}
    run_world("_timeline_rank_on_card", tmp_path, size=4,
              module="test_torch_negotiation", env=env, kv=True)
    for r in range(4):
        events = json.loads((tmp_path / f"tl.json.{r}").read_text())
        lanes: dict = {}
        for e in events:
            if e["ph"] in ("B", "E"):
                lanes.setdefault(e["cat"], []).append(e["name"])
        for name in TIMELINE_NAMES:
            assert lanes[f"{name}.0"] == ["NEGOTIATE"] * 2, (r, lanes)
            assert lanes[name] == ["ALLREDUCE"] * 2, (r, lanes)
        spans = {name: [e["ts"] for e in events if e.get("cat") == name]
                 for name in TIMELINE_NAMES}
        print(f"rank {r}: allreduce issue ranges (us) "
              f"{ {n: t[1] - t[0] for n, t in spans.items()} }")


# --------------------------------------------------------------------------
# the fusion cycle and step capture on the card (ops/fusion_cycle.py,
# ops/step_capture.py)
# --------------------------------------------------------------------------


def _capture_trainer(steps: int, capture: bool, move_at: int = -1):
    """A 2-layer TransformerLM at the kernels' head dim (bf16, d_model 512,
    8 heads, ulysses over a group of one) on 2 x 512 tokens, SGD with
    momentum, ``steps`` steps with the gradients kept in place, but at step
    ``move_at``, where each gradient moves to a new address (the old one
    kept alive, so that the allocator cannot hand it back): the
    parameters after them and the capture stats."""
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from horovod_tpu_torch.ops import dispatch_cache, fusion_cycle
    os.environ["HVD_STEP_CAPTURE"] = "1" if capture else "0"
    fusion_cycle.reset()
    dispatch_cache.reset()
    cfg = TransformerConfig(vocab_size=1000, num_layers=2, max_seq_len=512,
                            attn_mode="ulysses")
    model = TransformerLM(cfg, device=hvd.device())
    model.reset_parameters(torch.Generator().manual_seed(0))
    # SGD and a postscale of 1/2: at a world of one the reduction is then
    # no identity, and an update that read the gradients before the
    # replay wrote them would differ
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        postscale_factor=0.5)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1000, size=(2, 512))).to(hvd.device())
    kept = []
    for i in range(steps):
        opt.zero_grad(set_to_none=False)
        if i == move_at:
            for p in model.parameters():
                kept.append(p.grad)
                p.grad = torch.zeros_like(p)
        lm_loss(model(tokens), tokens).backward()
        opt.step()
    torch.cuda.synchronize()
    params = [p.detach().clone() for p in model.parameters()]
    return params, hvd.fusion_stats()["capture"]


@pytest.mark.cuda
def test_cuda_capture_world1_replays_one_graph_a_step(cuda_world,
                                                      monkeypatch):
    """At an NCCL world of one: the first step records, every later step
    replays one CUDA Graph of the step's sync, nothing diverges, and the
    parameters equal the eager run's bit for bit (or lie within the eager
    run's own spread, were it not bitwise equal to itself)."""
    monkeypatch.setenv("HVD_BUCKET_BYTES", str(8 << 20))
    eager, _ = _capture_trainer(5, False)
    again, _ = _capture_trainer(5, False)
    got, st = _capture_trainer(5, True)
    spread = max((a - b).abs().max().item() for a, b in zip(eager, again))
    diff = max((a - b).abs().max().item() for a, b in zip(eager, got))
    print(f"capture {st}; parameters against eager {diff:.3g}, eager "
          f"against itself {spread:.3g}")
    assert st["recorded_steps"] == 1 and st["replayed_steps"] == 4
    assert st["graph_launches"] == 4 and st["fallbacks"] == 0
    assert diff == 0.0 or diff <= spread


@pytest.mark.cuda
def test_cuda_capture_world1_moved_gradient_is_a_divergence(cuda_world,
                                                            monkeypatch):
    """A gradient at a new address (here every one, at step 3): the graph
    reads fixed ones, so that replay is a divergence, counted, and runs
    eagerly with the eager run's result; the next step records again and
    the one after replays a graph of the new addresses."""
    monkeypatch.setenv("HVD_BUCKET_BYTES", str(8 << 20))
    eager, _ = _capture_trainer(6, False, move_at=3)
    got, st = _capture_trainer(6, True, move_at=3)
    print(f"capture with moved gradients: {st}")
    assert st["fallbacks"] == 1 and st["moved_inputs"] == 1
    assert st["recorded_steps"] == 2 and st["replayed_steps"] == 3
    for a, b in zip(eager, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_nccl_world4_capture_trainer_bitwise(four_cards, tmp_path):
    """Four cards, the full-width trainer data-parallel (8 x 2048 tokens a
    card): capture off twice and on from one seed; the captured run
    records once and replays one CUDA Graph a step after, and its
    parameters equal the eager run's (bitwise, or within the eager run's
    own spread). Then the step with capture off and on in turns; rank 0's
    profiled steps give the first NCCL kernel's start against the
    backward pass's last kernel in each mode."""
    import json

    from test_torch_world2 import run_world
    ranks = run_world("_card_capture_rank", tmp_path, size=4,
                      module="test_torch_fusion_world")
    for r, res in enumerate(ranks):
        st = json.loads(str(res["capture"]))
        spread = float(np.abs(res["off"] - res["again"]).max())
        diff = float(np.abs(res["off"] - res["on"]).max())
        turns = json.loads(str(res["turns"]))
        print(f"rank {r}: capture {st}; parameters against eager {diff:.3g}"
              f" (eager spread {spread:.3g}); step ms off {turns['off']}, "
              f"on {turns['on']}; overlap {turns['overlap']}")
        assert st["replayed_steps"] >= 1 and st["fallbacks"] == 0, r
        assert st["graph_launches"] == st["replayed_steps"], r
        assert int(res["turn_fallbacks"]) == 0, r
        assert diff == 0.0 or diff <= spread, r
        np.testing.assert_array_equal(res["on"], ranks[0]["on"])


@pytest.mark.cuda
def test_cuda_nccl_world4_negotiated_capture_rounds(four_cards, tmp_path):
    """Four cards under the KV negotiation service, the full-width
    trainer's step with capture off (the flat negotiated step) and on, in
    turns: a replayed step takes one ``negotiate_step`` round; busy rounds
    and step times of both modes are printed."""
    import json

    from test_torch_world2 import run_world
    ranks = run_world("_card_svc_capture_rank", tmp_path, size=4,
                      module="test_torch_fusion_world", kv=True)
    for r, res in enumerate(ranks):
        turns = json.loads(str(res["turns"]))
        st = json.loads(str(res["capture"]))
        print(f"rank {r}: off {turns['off']}; on {turns['on']}; capture "
              f"{st}")
        assert np.isfinite(res["losses"]).all(), r
        assert st["fallbacks"] == 0, r
        assert turns["on"]["step_rounds"] == [1] * len(turns["on"]["ms"]), r


# --------------------------------------------------------------------------
# hvd.cached_step: the whole step as one CUDA Graph; TorchState on cards
# --------------------------------------------------------------------------

def _cached_trainer(hvd, steps: int, cached: bool, move_at=None,
                    full: bool = False, seed: int = 0, before=None):
    """The trainer (a small TransformerLM, or with ``full`` the full-width
    defaults on 8 x 2048 tokens a rank) with its gradients kept in place,
    ``steps`` steps eagerly or under ``hvd.cached_step`` with a fresh
    closure each step; at ``move_at`` every parameter gets new storage
    first; ``before(i, model, opt)``, if given, runs before step ``i``.
    SGD with momentum and a postscale of 1/2 (small), or
    ``Adam(capturable=True)`` (full). Returns the parameters after the
    steps, the losses and ``gspmd_cache_stats()``."""
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    from horovod_tpu_torch.ops import dispatch_cache, gspmd_cache
    dispatch_cache.reset()
    gspmd_cache.reset_stats()
    dev = hvd.device()
    if full:
        cfg = TransformerConfig(attn_mode="ulysses")
        shape = (8, 2048)
    else:
        cfg = TransformerConfig(vocab_size=1000, num_layers=2,
                                max_seq_len=512, attn_mode="ulysses")
        shape = (2, 512)
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if full:
        opt = hvd.DistributedOptimizer(torch.optim.Adam(
            model.parameters(), lr=1e-3, capturable=True))
    else:
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            postscale_factor=0.5)
    tokens = torch.from_numpy(np.random.default_rng(hvd.rank()).integers(
        0, cfg.vocab_size, size=shape)).to(dev)

    def make_step():
        def train_step(t):
            opt.zero_grad(set_to_none=False)
            loss = lm_loss(model(t), t)
            loss.backward()
            opt.step()
            return loss.detach()
        return train_step

    losses = []
    for i in range(steps):
        if i == move_at:
            with torch.no_grad():
                for p in model.parameters():
                    p.data = p.data.clone()
        if before is not None:
            before(i, model, opt)
        step = hvd.cached_step(make_step()) if cached else make_step()
        losses.append(step(tokens).item())
    torch.cuda.synchronize()
    params = [p.detach().clone() for p in model.parameters()]
    return params, losses, gspmd_cache.stats()


@pytest.mark.cuda
def test_cuda_cached_step_world1_replays_the_whole_step(cuda_world):
    """At an NCCL world of one: the first call runs eagerly and captures
    the step, every later call replays its graph, and the parameters equal
    the eager run's bit for bit (or lie within its own spread)."""
    import horovod_tpu_torch as hvd
    eager, el, _ = _cached_trainer(hvd, 5, False)
    again, _, _ = _cached_trainer(hvd, 5, False)
    got, cl, st = _cached_trainer(hvd, 5, True)
    spread = max((a - b).abs().max().item() for a, b in zip(eager, again))
    diff = max((a - b).abs().max().item() for a, b in zip(eager, got))
    print(f"cached_step {st}; parameters against eager {diff:.3g}, eager "
          f"against itself {spread:.3g}; losses {cl} / {el}")
    assert st["builds"] == 1 and st["events"] == {"recorded": 1,
                                                  "replayed": 4}
    assert diff == 0.0 or diff <= spread


@pytest.mark.cuda
def test_cuda_cached_step_world1_moved_parameter_rerecords(cuda_world):
    """Every parameter given new storage before step 3: that call's plan
    reads the old addresses, so it is dropped and the call runs plain
    (counted once as invalidated and as a fallback); step 4 records a new
    graph, step 5 replays it, and the result is the eager run's."""
    import horovod_tpu_torch as hvd
    eager, _, _ = _cached_trainer(hvd, 6, False, move_at=3)
    got, _, st = _cached_trainer(hvd, 6, True, move_at=3)
    print(f"cached_step with moved parameters: {st}")
    assert st["builds"] == 2 and st["hits"] == 3
    assert st["events"]["invalidated"] == 1
    assert st["events"]["fallback"] == 1
    for a, b in zip(eager, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_cached_step_world1_refuses_a_non_capturable_optimizer(
        cuda_world):
    """An optimizer whose step count is a host value cannot be captured:
    refused with an error before the step runs."""
    import horovod_tpu_torch as hvd
    model = torch.nn.Linear(8, 4, device=hvd.device())
    opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters()))
    x = torch.randn(3, 8, device=hvd.device())

    def train_step(t):
        opt.zero_grad()
        model(t).sum().backward()
        opt.step()

    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(ValueError, match="capturable"):
        hvd.cached_step(train_step)(x)
    assert all(torch.equal(a, p) for a, p in zip(before,
                                                   model.parameters()))


@pytest.mark.cuda
def test_cuda_cached_step_world1_lr_change_rerecords(cuda_world):
    """An LR scheduler stepped between calls (halving at steps 2 and 5):
    each change drops the plan whose graph froze the old ``lr`` (a plain
    call), the next call records a new graph, and the parameters are the
    eager run's bit for bit."""
    import horovod_tpu_torch as hvd
    scheds = {}

    def before(i, model, opt):
        if i == 0:
            scheds[id(model)] = torch.optim.lr_scheduler.MultiStepLR(
                opt.optimizer, milestones=[2, 5], gamma=0.5)
        else:
            scheds[id(model)].step()

    eager, _, _ = _cached_trainer(hvd, 7, False, before=before)
    got, _, st = _cached_trainer(hvd, 7, True, before=before)
    print(f"cached_step with an LR scheduler: {st}")
    assert st["builds"] == 3 and st["hits"] == 2
    assert st["events"]["invalidated"] == 2
    for a, b in zip(eager, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_cached_step_world1_replays_after_in_place_restore(cuda_world):
    """``TorchState`` commits after step 2; steps 3-4 replay, ``restore()``
    writes the commit back into the same tensors, and steps 5-6 replay the
    same graph (no record, no drop). The parameters are the eager run's
    through the same commit and restore, bit for bit."""
    import horovod_tpu_torch as hvd
    states = {}

    def before(i, model, opt):
        if i == 0:
            states[id(model)] = hvd.elastic.TorchState(model=model,
                                                       optimizer=opt)
        elif i == 2:
            states[id(model)].commit()
        elif i == 4:
            states[id(model)].restore()

    eager, el, _ = _cached_trainer(hvd, 6, False, before=before)
    got, cl, st = _cached_trainer(hvd, 6, True, before=before)
    print(f"cached_step across restore(): {st}; losses {cl} / {el}")
    assert st["builds"] == 1 and st["events"] == {"recorded": 1,
                                                  "replayed": 5}
    assert cl[4:] == cl[2:4] == el[2:4]
    for a, b in zip(eager, got):
        assert torch.equal(a, b)


class _CardHidden:
    shift = None  # a class attribute: no reach of the step walks classes


@pytest.mark.cuda
def test_cuda_cached_step_world1_hidden_tensor_is_unplannable(cuda_world):
    """A step that reads a tensor neither passed nor reached (a class
    attribute) cannot be checked for moves: its capture names it, the
    signature is UNPLANNABLE (one fallback) and every call runs plain,
    which still trains as the eager steps do."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import dispatch_cache, gspmd_cache
    dev = hvd.device()
    out = {}
    for cached in (False, True):
        dispatch_cache.reset()
        gspmd_cache.reset_stats()
        torch.manual_seed(0)
        model = torch.nn.Linear(8, 4, device=dev)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        _CardHidden.shift = torch.ones(4, device=dev)
        x = torch.randn(3, 8, device=dev,
                        generator=torch.Generator(dev).manual_seed(1))

        def train_step(t):
            opt.zero_grad(set_to_none=False)
            ((model(t) + _CardHidden.shift) ** 2).mean().backward()
            opt.step()

        for _ in range(3):
            (hvd.cached_step(train_step) if cached else train_step)(x)
        out[cached] = [p.detach().clone() for p in model.parameters()]
    st = gspmd_cache.stats()
    _CardHidden.shift = None
    assert st["builds"] == 0 and st["hits"] == 0
    assert st["events"] == {"fallback": 1}
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_cached_step_world1_refuses_numpy_arguments(cuda_world):
    """A numpy argument would be read from host memory a graph cannot
    follow: refused with an error before the step runs."""
    import horovod_tpu_torch as hvd
    model = torch.nn.Linear(8, 4, device=hvd.device())

    def train_step(x):
        return model(torch.from_numpy(x).to(hvd.device())).sum()

    with pytest.raises(TypeError, match="numpy"):
        hvd.cached_step(train_step)(torch.zeros(1, device=hvd.device()),
                                    np.zeros((3, 8), np.float32))


def _card_cached_step_rank(out_path: str) -> None:
    """Four cards: the full-width trainer eagerly twice (its own spread)
    and under ``cached_step``, from one seed."""
    import json

    import horovod_tpu_torch as hvd
    hvd.init()
    try:
        off, _, _ = _cached_trainer(hvd, 5, False, full=True)
        again, _, _ = _cached_trainer(hvd, 5, False, full=True)
        on, losses, st = _cached_trainer(hvd, 5, True, full=True)
        flat = lambda ps: torch.cat([p.reshape(-1).float()  # noqa: E731
                                     for p in ps]).cpu().numpy()
        np.savez(out_path, off=flat(off), again=flat(again), on=flat(on),
                 losses=np.asarray(losses), stats=json.dumps(st))
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_cuda_nccl_world4_cached_step_trainer_bitwise(four_cards, tmp_path):
    """Four cards, the full-width trainer data-parallel with NCCL inside
    the graph: one record and four replays a rank, no fallback, and every
    rank's parameters equal its eager run's (bitwise, or within the eager
    run's own spread) and rank 0's."""
    import json

    from test_torch_world2 import run_world
    ranks = run_world("_card_cached_step_rank", tmp_path, size=4,
                      module="test_torch_cuda")
    for r, res in enumerate(ranks):
        st = json.loads(str(res["stats"]))
        spread = float(np.abs(res["off"] - res["again"]).max())
        diff = float(np.abs(res["off"] - res["on"]).max())
        print(f"rank {r}: cached_step {st}; parameters against eager "
              f"{diff:.3g} (eager spread {spread:.3g}); losses "
              f"{res['losses'].tolist()}")
        assert st["builds"] == 1 and st["events"] == {"recorded": 1,
                                                      "replayed": 4}, r
        assert diff == 0.0 or diff <= spread, r
        np.testing.assert_array_equal(res["on"], ranks[0]["on"])


def _card_peer_restore_rank(out_path: str) -> None:
    """Four cards: ``TorchState`` over a small TransformerLM on the card,
    three commits; the last rank then becomes a fresh joiner (other
    parameters and Adam state, one commit) and ``sync()`` pulls its shards
    from the survivors over the KV store."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)
    hvd.init()
    try:
        r, n, dev = hvd.rank(), hvd.size(), hvd.device()
        cfg = TransformerConfig(vocab_size=1000, num_layers=2,
                                max_seq_len=512, attn_mode="ulysses")
        model = TransformerLM(cfg, device=dev)
        model.reset_parameters(torch.Generator().manual_seed(0))
        opt = hvd.DistributedOptimizer(torch.optim.Adam(
            model.parameters(), lr=1e-3, capturable=True))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, 1000, size=(2, 512))).to(dev)

        def step():
            opt.zero_grad(set_to_none=False)
            lm_loss(model(tokens), tokens).backward()
            opt.step()

        state = hvd.elastic.TorchState(model=model, optimizer=opt, epoch=0)
        for i in range(3):
            step()
            state.epoch = i + 1
            state.commit()
        ptrs = [p.data_ptr() for p in model.parameters()]
        if r == n - 1:
            # other values in the same tensors, with no collective (a
            # step's gradient hooks would start the buckets' allreduce)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(-0.5)
                    for v in opt.state[p].values():
                        v.add_(1.0)
            state.epoch = 0
            state.save()
            state._commits = 1
        state.sync()
        torch.cuda.synchronize()
        snap = hvd.metrics.snapshot()
        pulled = sum(v for (name, _), v in snap.items()
                     if name == "hvd_ckpt_peer_shards_pulled_total")
        params = torch.cat([p.detach().reshape(-1).float()
                            for p in model.parameters()]).cpu().numpy()
        moments = torch.cat([v.reshape(-1).float()
                             for p in model.parameters()
                             for k, v in sorted(opt.state[p].items())]
                            ).cpu().numpy()
        np.savez(out_path, params=params, moments=moments,
                 epoch=state.epoch, pulled=pulled,
                 in_place=ptrs == [p.data_ptr()
                                   for p in model.parameters()])
    finally:
        hvd.shutdown()


@pytest.mark.cuda
def test_cuda_nccl_world4_peer_restore_bitwise(four_cards, tmp_path):
    """Four cards: after ``TorchState.sync()`` the joiner holds rank 0's
    committed parameters and Adam state bit for bit, in the same tensors,
    having pulled one shard from each of the three survivors."""
    from test_torch_world2 import run_world
    ranks = run_world("_card_peer_restore_rank", tmp_path, size=4,
                      module="test_torch_cuda", kv=True,
                      env={"HVD_DYNAMIC_ENGINE": "0"})
    for r, res in enumerate(ranks):
        print(f"rank {r}: epoch {int(res['epoch'])}, shards pulled "
              f"{int(res['pulled'])}")
        assert int(res["epoch"]) == 3 and bool(res["in_place"]), r
        np.testing.assert_array_equal(res["params"], ranks[0]["params"])
        np.testing.assert_array_equal(res["moments"], ranks[0]["moments"])
    assert [int(res["pulled"]) for res in ranks] == [0, 0, 0, 3]


# --------------------------------------------------------------------------
# The launcher and elastic training on cards
# --------------------------------------------------------------------------

def _launch(argv: list, tmp_path, env=None, timeout=900):
    """``python -m horovod_tpu_torch.runner.launch *argv`` with NCCL's
    flight recorder dumping under ``tmp_path`` and every rank's stacks on
    a hang; its output is printed and returned (stdout, stderr)."""
    full = {**os.environ, "PYTHONFAULTHANDLER": "1",
            "TORCH_NCCL_TRACE_BUFFER_SIZE": "2000",
            "TORCH_FR_BUFFER_SIZE": "2000", "TORCH_NCCL_DUMP_ON_TIMEOUT": "1",
            "TORCH_NCCL_DEBUG_INFO_TEMP_FILE": str(tmp_path / "nccl_trace_"),
            "TORCH_FR_DUMP_TEMP_FILE": str(tmp_path / "nccl_trace_"),
            **(env or {})}
    proc = subprocess.run(LAUNCH + argv, capture_output=True, text=True,
                          timeout=timeout, env=full, cwd=REPO)
    dumps = sorted(p.name for p in tmp_path.glob("nccl_trace_*"))
    assert proc.returncode == 0, (
        f"exit {proc.returncode}; flight-recorder dumps {dumps}\n"
        + proc.stdout[-20000:] + proc.stderr[-20000:])
    return proc.stdout, proc.stderr


@pytest.mark.cuda
def test_cuda_elastic_world1_reforms_in_place(cuda_device):
    """chip_smoke.py's ``[elastic]`` phase: the cached trainer at full
    width under ``hvd.elastic.run`` through the elastic launcher at
    ``--min-np 1 --max-np 1``; a new round that keeps the slot re-forms
    the world in the worker's own process (a new NCCL group on the same
    card, the cached step recorded again) and the run stays bitwise the
    uninterrupted one."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    out, launches = chip_smoke.phase_elastic(torch.device("cuda", 0))
    print(json.dumps(out["reform_s"]), launches)
    assert out["bitwise"] and out["gspmd"]["events"]["recorded"] == 2


@pytest.mark.cuda
def test_cuda_nccl_world4_launch_static_trainer(four_cards, tmp_path):
    """``python -m horovod_tpu_torch.runner.launch -np 4`` of the trainer
    (chip_smoke.py's ``[launch]`` worker, full width, NCCL): one card a
    worker from the launcher's pool, and every rank's losses and
    parameters bitwise rank 0's."""
    _launch(["-np", "4", "--", sys.executable, str(REPO / "chip_smoke.py"),
             "--trainer-worker", str(tmp_path / "rank{rank}.json")],
            tmp_path)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    assert sorted(r["env"]["HVD_CUDA_DEVICE"] for r in ranks) == \
        ["0", "1", "2", "3"]
    assert sorted(r["device"] for r in ranks) == [f"cuda:{i}"
                                                  for i in range(4)]
    for r in ranks:
        assert (r["world"], r["backend"]) == (4, "nccl")
        assert r["losses"] == ranks[0]["losses"]
        assert r["params_sha256"] == ranks[0]["params_sha256"]
        assert set(r["launches"].values()) == {r["layers"] * 5}
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    print(f"four-card launch: losses {ranks[0]['losses']}")


ELASTIC_CARD_STEPS = 12


def _card_elastic_rank(out_dir: str) -> None:
    """An elastic worker of :func:`test_cuda_nccl_world4_elastic_remove_
    and_add`: the trainer at full width (2 x 2048 tokens a rank, its
    rank's own data) with ``TorchState``, committing every step; it logs
    each (re-)entry into training and each commit (its save, also where an
    interrupt then ends the commit) with a digest of its parameters."""
    import hashlib
    from horovod_tpu_torch import elastic
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)

    hvd.init()
    dev = hvd.device()
    cfg = TransformerConfig(attn_mode="ulysses")
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3))
    state = elastic.TorchState(model=model, optimizer=opt, step=0)
    log = open(os.path.join(out_dir, f"worker{os.getpid()}.jsonl"), "a")

    def record(kind):
        h = hashlib.sha256()
        for p in model.parameters():
            h.update(p.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        log.write(json.dumps({
            "kind": kind, "round": int(os.environ["HVD_ELASTIC_ROUND"]),
            "rank": hvd.rank(), "size": hvd.size(), "step": state.step,
            "card": str(hvd.device()), "sha": h.hexdigest(),
            "t": time.time()}) + "\n")
        log.flush()

    save = state.save

    def recorded_save():  # every commit, also one an interrupt ends
        save()
        record("commit")

    state.save = recorded_save

    @elastic.run
    def train(state):
        record("entered")
        while state.step < ELASTIC_CARD_STEPS:
            rng = np.random.default_rng(1000 * state.step + hvd.rank())
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=(2, 2048))).to(dev)
            opt.zero_grad()
            lm_loss(model(tokens), tokens).backward()
            opt.step()
            state.step += 1
            state.commit()

    train(state)
    record("done")
    hvd.shutdown()


@pytest.mark.cuda
def test_cuda_nccl_world4_elastic_remove_and_add(four_cards, tmp_path):
    """An elastic job over two aliases of this machine, two slots each
    (``-H localhost:2,127.0.0.1:2``): ``worker:remove`` takes
    ``127.0.0.1``'s two workers abruptly (4 -> 2: the survivors abort
    NCCL, restore the last commit and lose at most one step), and
    ``worker:add`` brings the host back (2 -> 4: the newcomers take the
    state by peer restore). After each re-form every rank's parameters are
    bitwise rank 0's and the last commit's; no two workers share a card."""
    _launch(["-np", "4", "--min-np", "2", "--max-np", "4", "-H",
             "localhost:2,127.0.0.1:2", "--", sys.executable,
             str(Path(__file__).resolve()), "--elastic-rank",
             str(tmp_path)], tmp_path, env={
                 "HVD_FAULT_SPEC": "worker:remove:rank=2:at_step=3;"
                                   "worker:add:rank=0:at_round=2:after=1",
                 "HVD_PROCESS_GROUP_TIMEOUT": "30",
                 "HVD_HEALTH_INTERVAL": "0.5", "HVD_HEALTH_TIMEOUT": "5",
                 "HVD_ELASTIC_TIMEOUT": "300"})
    recs = [json.loads(line) for f in sorted(tmp_path.glob("worker*.jsonl"))
            for line in f.read_text().splitlines()]
    commits = {(r["round"], r["step"]): r["sha"] for r in recs
               if r["kind"] == "commit" and r["rank"] == 0}
    rounds = sorted({r["round"] for r in recs})
    sizes = {rnd: {r["size"] for r in recs if r["round"] == rnd}
             for rnd in rounds}
    print(f"rounds {rounds}, sizes {sizes}")
    assert rounds == [1, 2, 3] and sizes == {1: {4}, 2: {2}, 3: {4}}
    for rnd in (2, 3):
        entered = [r for r in recs if r["kind"] == "entered"
                   and r["round"] == rnd]
        assert sorted(r["rank"] for r in entered) == list(range(
            sizes[rnd].pop()))
        assert len({r["sha"] for r in entered}) == 1, entered
        assert len({r["card"] for r in entered}) == len(entered)
        step = entered[0]["step"]
        last = max(s for (rd, s) in commits if rd == rnd - 1)
        assert step == last, (rnd, step, last)
        assert entered[0]["sha"] == commits[(rnd - 1, last)]
        # the re-form's time: the old round's last commit to the last rank
        # of the new round back in training
        took = max(r["t"] for r in entered) - max(
            r["t"] for r in recs if r["kind"] == "commit"
            and r["round"] == rnd - 1)
        print(f"round {rnd}: {len(entered)} ranks entered at step {step}, "
              f"bitwise the last commit, {took:.1f} s after it")
    done = [r for r in recs if r["kind"] == "done"]
    assert len(done) == 4 and len({r["sha"] for r in done}) == 1
    assert {r["step"] for r in done} == {ELASTIC_CARD_STEPS}


@pytest.mark.cuda
def test_cuda_nccl_world4_launch_long_context_twin_ulysses(four_cards,
                                                           tmp_path):
    """ROADMAP C3 through the launcher: the Ulysses long-context twin at
    ``-np 4``, 65536 tokens (16384 a rank) at full width for 3 steps, with
    every rank's stacks on a hang and NCCL's flight recorder dumping under
    ``tmp_path`` on a collective's timeout."""
    out, _ = _launch(["-np", "4", "--", sys.executable, "-m",
                      "horovod_tpu_torch.examples.long_context_lm",
                      "--model", "full", "--attn", "ulysses", "--seq-len",
                      "65536", "--batch", "1", "--steps", "3"], tmp_path,
                     env={"HVD_PROCESS_GROUP_TIMEOUT": "120"})
    assert "OK" in out
    print([line for line in out.splitlines() if "[0]<stdout>" in line][-3:])


# --------------------------------------------------------------------------
# The autoscale policy and the Ray executor on cards
# --------------------------------------------------------------------------

# The closed loop. A commit copies the trainer's 557 MB state to the host
# (0.29-0.39 s, PERF.md), so an idle step takes about 0.3-0.45 s: with the SLO
# at 3 s and idle under 0.5 x SLO = 1.5 s, an idle step has a 3.3x margin;
# the busy phase's offered load of 20 s (the JAX test's model: the load
# shared by the world, 10 s a step at 2) has 3.3x over the SLO. The remove
# is the policy's first action, so no recovery has been measured and the
# restore-cost brake lets it through; its windows (3 x 2 s) would exceed
# the 0.6-1.06 s re-form measured at world 1 (PERF.md) as well.
AUTOSCALE_CARD_ENV = {
    "HVD_AUTOSCALE": "1", "HVD_AUTOSCALE_SLO_MS": "3000",
    "HVD_AUTOSCALE_INTERVAL": "2", "HVD_AUTOSCALE_IDLE_WINDOWS": "3",
    "HVD_AUTOSCALE_BREACH_WINDOWS": "2", "HVD_AUTOSCALE_IDLE_FACTOR": "0.5",
    "HVD_AUTOSCALE_COOLDOWN": "4", "HVD_AUTOSCALE_GRACE": "120"}
BUSY_LOAD_S, TAIL_STEPS, CARD_MAX_STEPS = 20.0, 3, 400
# Evict and replace: rank 2 of round 1 submits each negotiation round 0.4 s
# late, 4x the straggler threshold; the SLO is 0, so the breach and idle
# rules are off and eviction alone acts.
EVICT_CARD_ENV = {
    "HVD_AUTOSCALE": "1", "HVD_AUTOSCALE_SLO_MS": "0",
    "HVD_AUTOSCALE_INTERVAL": "1", "HVD_AUTOSCALE_EVICT_WINDOWS": "2",
    "HVD_AUTOSCALE_COOLDOWN": "4", "HVD_AUTOSCALE_GRACE": "120",
    "HVD_RESPONSE_CACHE": "0", "HVD_STRAGGLER_THRESHOLD": "0.1",
    "HVD_FAULT_SPEC": "svc.exchange:delay=0.4:rank=2:at_round=1"}


def _card_autoscale_rank(out_dir: str, scenario: str) -> None:
    """A worker of the four-card autoscale tests: the trainer at full width
    (2 x 2048 tokens a rank) under ``TorchState``, committing every step.
    ``loop``: idle (no added load) until the world shrinks, then busy
    (``BUSY_LOAD_S / world`` seconds a step) until it grows back, then
    ``TAIL_STEPS`` idle steps. ``evict``: train until a round after the
    first has run ``TAIL_STEPS`` steps. Each commit and (re-)entry is
    logged with the world, the card and a digest of the parameters."""
    import hashlib
    from horovod_tpu_torch import elastic, metrics
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (TransformerConfig, TransformerLM,
                                          lm_loss)

    hvd.init()
    dev = hvd.device()
    cfg = TransformerConfig(attn_mode="ulysses")
    model = TransformerLM(cfg, device=dev)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3))
    state = elastic.TorchState(model=model, optimizer=opt, step=0,
                               phase="idle", tail_from=-1)
    log = open(os.path.join(out_dir, f"worker{os.getpid()}.jsonl"), "a")

    def record(kind):
        h = hashlib.sha256()
        for p in model.parameters():
            h.update(p.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        log.write(json.dumps({
            "kind": kind, "round": int(os.environ["HVD_ELASTIC_ROUND"]),
            "rank": hvd.rank(), "size": hvd.size(), "step": state.step,
            "phase": state.phase, "card": str(hvd.device()),
            "host": os.environ.get("HVD_HOSTNAME"), "sha": h.hexdigest(),
            "lost": metrics.ELASTIC_STEPS_LOST.value(),
            "t": time.time()}) + "\n")
        log.flush()

    save = state.save

    def recorded_save():
        save()
        record("commit")

    state.save = recorded_save

    @elastic.run
    def train(state):
        record("entered")
        entered, rnd = state.step, int(os.environ["HVD_ELASTIC_ROUND"])
        while state.step < CARD_MAX_STEPS:
            size = hvd.size()
            if scenario == "evict":
                if rnd > 1 and state.step >= entered + TAIL_STEPS:
                    break
            else:
                if state.phase == "idle" and size < 4:
                    state.phase = "busy"
                elif state.phase == "busy" and size == 4:
                    state.phase, state.tail_from = "tail", state.step
                if state.phase == "tail" \
                        and state.step >= state.tail_from + TAIL_STEPS:
                    break
            rng = np.random.default_rng(1000 * state.step + hvd.rank())
            tokens = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=(2, 2048))).to(dev)
            opt.zero_grad()
            lm_loss(model(tokens), tokens).backward()
            opt.step()
            if state.phase == "busy":
                time.sleep(BUSY_LOAD_S / size)
            state.step += 1
            state.commit()

    train(state)
    record("done")
    hvd.shutdown()


def _autoscale_job(tmp_path, scenario: str, env: dict, readmit=None):
    """``start_elastic`` of :func:`_card_autoscale_rank` over
    ``-H localhost:2,127.0.0.1:2 --min-np 2 --max-np 4`` in this process
    (its driver and policy here); ``readmit`` (host, slots) is entered
    among the hosts taken out earlier, for the policy to bring back.
    Returns the policy's decisions and the workers' records."""
    from horovod_tpu_torch.elastic import launch as elastic_launch
    from horovod_tpu_torch.runner import launch as launch_mod
    env = {**env, "HVD_PROCESS_GROUP_TIMEOUT": "120",
           "PYTHONFAULTHANDLER": "1"}
    args = launch_mod.parse_args(
        ["-np", "4", "--min-np", "2", "--max-np", "4",
         "-H", "localhost:2,127.0.0.1:2",
         *[a for k, v in env.items() for a in ("--env", f"{k}={v}")],
         "--", sys.executable, str(Path(__file__).resolve()),
         "--autoscale-rank", str(tmp_path), scenario])
    saved = os.environ.get("HVD_ELASTIC_TIMEOUT")
    os.environ["HVD_ELASTIC_TIMEOUT"] = "600"  # the driver's
    try:
        job = elastic_launch.start_elastic(args, args.command[1:])
        assert job.policy is not None
        if readmit:
            hosts = job.policy.hosts
            with hosts._mu:
                hosts._removed.append(readmit)
        rc = job.wait()
    finally:
        if saved is None:
            del os.environ["HVD_ELASTIC_TIMEOUT"]
        else:
            os.environ["HVD_ELASTIC_TIMEOUT"] = saved
    decisions = job.policy.policy_stats()["decisions"]
    recs = [json.loads(line) for f in sorted(tmp_path.glob("worker*.jsonl"))
            for line in f.read_text().splitlines()]
    print("decisions:", [(d["action"], d["reason"], d["rank"], d["detail"])
                         for d in decisions])
    assert rc == 0, rc
    return decisions, recs


def _check_reforms(recs):
    """Every rank of every round entered bitwise at the last commit of the
    round before, on a card of its own; no committed step replays; no
    step lost; the ranks done bitwise equal."""
    rounds = sorted({r["round"] for r in recs})
    commits = {}
    for r in recs:
        if r["kind"] == "commit" and r["rank"] == 0:
            commits.setdefault(r["round"], []).append((r["step"], r["sha"]))
    steps = [s for rnd in rounds for s, _ in commits.get(rnd, [])]
    assert steps == list(range(1, len(steps) + 1)), steps  # no replay
    for rnd in rounds[1:]:
        entered = [r for r in recs if r["kind"] == "entered"
                   and r["round"] == rnd]
        last_step, last_sha = commits[rnd - 1][-1]
        assert {r["step"] for r in entered} == {last_step}, (rnd, entered)
        assert {r["sha"] for r in entered} == {last_sha}
        assert len({r["card"] for r in entered}) == len(entered)
        took = max(r["t"] for r in entered) - max(
            r["t"] for r in recs if r["kind"] == "commit"
            and r["round"] == rnd - 1)
        print(f"round {rnd}: world {entered[0]['size']}, entered at step "
              f"{last_step} bitwise its last commit, {took:.1f} s after it; "
              f"cards {sorted(r['card'] for r in entered)}, hosts "
              f"{sorted(r['host'] for r in entered)}")
    done = [r for r in recs if r["kind"] == "done"]
    assert len(done) == 4 and len({r["sha"] for r in done}) == 1
    assert all(r["lost"] == 0 for r in recs)
    return rounds


@pytest.mark.cuda
def test_cuda_world1_broadcast_optimizer_state_of_adam(cuda_world):
    """Torch's Adam keeps its step count on the host beside moments on the
    card; ``broadcast_optimizer_state`` takes both (the estimator's resume
    does, ``spark/estimator.py``)."""
    import horovod_tpu_torch as hvd
    model = torch.nn.Linear(8, 4).to(cuda_world)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.ones(2, 8, device=cuda_world)).sum().backward()
    opt.step()
    state = opt.state[model.weight]
    assert state["step"].device.type == "cpu"
    assert state["exp_avg"].device.type == "cuda"
    before = {k: v.clone() for k, v in state.items()}
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    for k, v in state.items():
        assert v.device == before[k].device and torch.equal(v, before[k])


@pytest.mark.cuda
def test_cuda_nccl_world4_autoscale_closed_loop(four_cards, tmp_path):
    """The closed loop on four cards: an idle load makes the policy remove
    the host of the highest ranks gracefully (4 -> 2), a load past the SLO
    makes it re-admit that host (2 -> 4); one ``remove/idle`` and one
    ``add/slo-breach`` (at most one more decision), no step lost, no
    committed step replayed, the ranks bitwise equal at the end."""
    decisions, recs = _autoscale_job(tmp_path, "loop", AUTOSCALE_CARD_ENV)
    acts = [d for d in decisions if d["action"] != "hold"]
    assert [(d["action"], d["reason"]) for d in acts[:2]] == [
        ("remove", "idle"), ("add", "slo-breach")], acts
    assert len(acts) <= 3, acts
    gone = acts[0]["detail"].split()[0][1:]
    assert acts[1]["detail"].startswith(f"+{gone} "), acts
    rounds = _check_reforms(recs)
    sizes = [{r["size"] for r in recs if r["round"] == rnd}
             for rnd in rounds]
    assert sizes[:3] == [{4}, {2}, {4}], sizes


@pytest.mark.cuda
def test_cuda_nccl_world4_autoscale_evicts_and_replaces(four_cards,
                                                        tmp_path):
    """A straggler on four cards: rank 2 of round 1 submits every
    negotiation round late; the policy evicts its host (``evict/straggler``
    naming rank 2) and brings back the machine's own name, entered here
    as a host of two slots taken out earlier (``CardPool.machine`` maps it
    to this machine's cards), whose workers wait for the cards the victims
    free; the world is back at 4 with no step lost."""
    import socket
    own_name = socket.gethostname()
    decisions, recs = _autoscale_job(tmp_path, "evict", EVICT_CARD_ENV,
                                     readmit=(own_name, 2))
    acts = [d for d in decisions if d["action"] != "hold"]
    assert acts and (acts[0]["action"], acts[0]["reason"],
                     acts[0]["rank"]) == ("evict", "straggler", 2), acts
    victim = acts[0]["detail"].split()[0][1:]
    assert acts[0]["detail"] == f"-{victim} +{own_name}", acts
    rounds = _check_reforms(recs)
    assert rounds[:2] == [1, 2]
    second = [r for r in recs if r["kind"] == "entered" and r["round"] == 2]
    assert sorted(r["rank"] for r in second) == [0, 1, 2, 3]
    assert sorted(r["card"] for r in second) == [f"cuda:{i}"
                                                 for i in range(4)]
    assert victim not in {r["host"] for r in second}
    assert sum(r["host"] == own_name for r in second) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("gpus", [0, 4], ids=["cards-from-pool",
                                              "gpus-from-ray"])
def test_cuda_nccl_world4_ray_executor_trainer(four_cards, tmp_path,
                                               monkeypatch, gpus):
    """``RayExecutor(num_workers=4)`` over ``testing.make_process_ray`` (an
    actor is a child process): the trainer (chip_smoke.py's ``[launch]``
    worker) on four cards, every rank's losses and parameters bitwise rank
    0's. Where the cluster offers Ray no GPUs, each actor sees every card
    and drives cards 0-3 from the executor's card pool; where it offers
    four, each actor asks for one and sees only the GPU Ray gave it."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from horovod_tpu_torch import testing
    ray = testing.make_process_ray({"127.0.0.1": 4}, gpus=gpus)
    monkeypatch.setitem(sys.modules, "ray", ray)
    from horovod_tpu_torch.ray import RayExecutor
    ex = RayExecutor(num_workers=4)
    ex.start()
    try:
        ranks = ex.run(chip_smoke.returning_trainer_worker,
                       args=(str(tmp_path / "rank{rank}.json"),))
    finally:
        ex.shutdown()
        ray.shutdown()
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    if gpus:
        assert [r["env"]["HVD_CUDA_DEVICE"] for r in ranks] == ["0"] * 4
        assert sorted(r["env"]["CUDA_VISIBLE_DEVICES"] for r in ranks) == \
            ["0", "1", "2", "3"]
    else:
        assert sorted(r["env"]["HVD_CUDA_DEVICE"] for r in ranks) == \
            ["0", "1", "2", "3"]
    assert len({r["card_uuid"] for r in ranks}) == 4
    for r in ranks:
        assert (r["world"], r["backend"]) == (4, "nccl")
        assert r["losses"] == ranks[0]["losses"]
        assert r["params_sha256"] == ranks[0]["params_sha256"]
        assert set(r["launches"].values()) == {r["layers"] * 5}
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    print(f"four-card RayExecutor ({'Ray' if gpus else 'the pool'} gives "
          f"the cards): losses {ranks[0]['losses']}")


if __name__ == "__main__":
    if sys.argv[1] == "--elastic-rank":
        _card_elastic_rank(sys.argv[2])
    elif sys.argv[1] == "--autoscale-rank":
        _card_autoscale_rank(sys.argv[2], sys.argv[3])
