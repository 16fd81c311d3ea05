"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a card. The
file imports nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash
from horovod_tpu_torch.parallel import sequence


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _block(g, device, dtype, bh, sq, sk, d, qpos0, kpos0, causal):
    """Seeded inputs whose lse and D are those of a real forward pass."""
    q, k, v = (torch.randn((bh, n, d), generator=g).to(device, dtype)
               for n in (sq, sk, sk))
    q = (q.float() / d ** 0.5).to(dtype)
    m = torch.full((bh, sq, 1), flash.NEG_INF, device=device)
    l = torch.zeros((bh, sq, 1), device=device)
    acc = torch.zeros((bh, sq, d), device=device)
    m, l, acc = flash.attend_plain(q, k, v, qpos0, kpos0, causal, m, l, acc)
    l_safe = l.clamp_min(1e-30)
    dout = torch.randn((bh, sq, d), generator=g).to(device)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 13, 11, 3, 0), (3, 130, 200, 0, 70),
                                   (2, 64, 64, 0, 0), (1, 300, 40, 500, 0),
                                   (2, 63, 65, 0, 0), (2, 129, 127, 0, 0),
                                   (1, 2047, 2049, 0, 0),
                                   (1, 300, 40, 0, 200)])
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
    bh, sq, sk, qpos0, kpos0 = shape
    g = torch.Generator().manual_seed(sq * 1000 + sk)
    q, k, v, lse, dout, D = _block(g, cuda_device, dtype, bh, sq, sk, d,
                                   qpos0, kpos0, causal)
    m0 = torch.randn((bh, sq, 1), generator=g).to(cuda_device)
    l0 = torch.rand((bh, sq, 1), generator=g).to(cuda_device)
    acc0 = torch.randn((bh, sq, d), generator=g).to(cuda_device)
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
