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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 13, 11, 3, 0), (3, 130, 200, 0, 70),
                                   (2, 64, 64, 0, 0), (1, 300, 40, 500, 0)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernels_match_plain(cuda_device, causal, d, shape, dtype, tol):
    """Each kernel against its plain version at ragged and offset shapes,
    one launch each, from random incoming carries. m: rtol = atol = 1e-5
    (a max of float32 dot products summed in another order); l: rtol 1e-4;
    acc / l and the gradients: float32 rtol = atol = 1e-4, bf16 2e-2 (p
    rounded to bf16 against the running, not the final, row max)."""
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
