"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a card; the
``world4`` tests (NCCL over four ranks, one card each) skip on a host with
fewer than four. The file imports nothing of JAX, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
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
def test_cuda_nccl_world4_long_context_twin(four_cards, attn):
    """``python -m horovod_tpu_torch.examples.long_context_lm`` over four
    cards, 65536 tokens (16384 a rank) at full width for 3 steps: every
    rank exits 0, so the loss fell (the twin raises where it does not)."""
    from test_torch_long_context import twin
    logs = twin(4, ["--model", "full", "--attn", attn, "--seq-len",
                    "65536", "--batch", "1", "--steps", "3"])
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
