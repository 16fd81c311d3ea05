"""The port's DeepSeek-V3-style model (``models/deepseek_v3.py``) and its
dropless expert layer (``parallel/moe.py``) against the benchmark's plain
reference (``perfbench/reference/deepseek_v3_lm.py``, float32), on seeded
random weights at a small size on the CPU.

The JAX package has no such model, so the reference is the plain one the
benchmark's ``correct`` uses; the tests import the same file. Widths are
cut (hidden 64, two heads of q/k 24 and v 16, latent 32, experts of 32),
the structure is Moonlight's: a dense first layer, then expert layers of
``router_outputs`` routed experts of which ``n_routed_experts`` are held,
``num_experts_per_tok`` picks, two shared experts.

Tolerances. The program in float32 differs from the reference only in
the order of its sums (the flash form's online softmax over one block
against a softmax over query blocks; the grouped GEMM's rows sorted by
expert against one product an expert; float32 combine sums in a fixed
order against ``index_add``): ``F32`` relative to the largest entry. In
bf16 (the card's products) the loss is held to ``BF16_LOSS``: bf16
rounds each product's inputs and result to 8 bits.
"""

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch import metrics
from horovod_tpu_torch.models import deepseek_v3 as tds
from horovod_tpu_torch.parallel import moe
from perfbench.families import deepseek_v3_lm as family
from perfbench.frozen import weights
from perfbench.reference import deepseek_v3_lm as ref
from perfbench.reference import lowp, train as ref_train

REPO = Path(__file__).resolve().parent.parent
SEED = 2**31 + 19
F32 = 2e-5    # float32: the same sums in another order
BF16_LOSS = 2e-2  # bf16 products: 8-bit mantissas in and out of each
ADAM_STEP = 1e-2  # of lr: see test_model_step_matches_reference


def small_config(**over) -> dict:
    """The benchmark's Moonlight configuration at small widths."""
    cfg = json.loads((REPO / "perfbench/configs/moonlight-16b-a3b.json")
                     .read_text())
    cfg.update({"hidden_size": 64, "num_attention_heads": 2,
                "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                "v_head_dim": 16, "kv_lora_rank": 32,
                "moe_intermediate_size": 32, "intermediate_size": 96,
                "n_routed_experts": 4, "router_outputs": 8,
                "num_experts_per_tok": 3, "num_hidden_layers": 3,
                "vocab_size": 128, "compute_dtype": "float32"})
    cfg.update(over)
    return cfg


def _tokens(cfg, n=2, s=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg["vocab_size"], (n, s), generator=g)


def _ref_params(cfg):
    spec = ref.param_spec(cfg)
    p = {name: torch.empty(shape) for name, shape, _ in spec}
    weights.fill(p, spec, SEED)
    return {n: t.requires_grad_() for n, t in p.items()}


def _close(got, want, tol, what):
    err = (got.detach().double() - want.detach().double()).abs().max()
    scale = want.detach().double().abs().max().clamp_min(1e-30)
    assert err <= tol * scale, f"{what}: {err.item():.3g} of {scale:.3g}"


# --------------------------------------------------------------------------
# the parts, each against the reference's
# --------------------------------------------------------------------------


def case_mla():
    """MLA alone: block 0's attention on a random normed input, output and
    the gradients of the input and of its five weights."""
    cfg = small_config()
    model = family.build(cfg, SEED, "cpu")
    p = _ref_params(cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 24, 64), generator=g)
    ct = torch.randn((2, 24, 64), generator=g)
    xp = x.clone().requires_grad_()
    attn = model.blocks[0].attn
    out = attn(xp, torch.arange(24))
    out.backward(ct)
    xr = x.clone().requires_grad_()
    want = ref.attention(xr, p, "blocks.0.attn.", cfg, lowp.FP32)
    want.backward(ct)
    _close(out, want, F32, "out")
    _close(xp.grad, xr.grad, F32, "dx")
    for name, w in attn.named_parameters():
        _close(w.grad, p["blocks.0.attn." + name].grad, F32, name)


def case_router():
    """The router's choice (exactly the reference's experts) and its
    weights and scores, and their gradient through the weights."""
    cfg = small_config()
    g = torch.Generator().manual_seed(2)
    x = torch.randn((48, 64), generator=g)
    w_r = torch.randn((8, 64), generator=g) * 0.3
    wp = w_r.clone().requires_grad_()
    idx, w, scores = moe.route_sigmoid_top_k(
        x @ wp.t(), torch.zeros(8), 3, cfg["routed_scaling_factor"])
    wr = w_r.clone().requires_grad_()
    ridx, rw, rscores = ref.route(x, wr, cfg)
    assert torch.equal(idx, ridx)
    _close(w, rw, F32, "weights")
    _close(scores, rscores, F32, "scores")
    assert torch.allclose(w.sum(-1), torch.full((48,), 2.446))
    (w * torch.arange(3.0)).sum().backward()
    (rw * torch.arange(3.0)).sum().backward()
    _close(wp.grad, wr.grad, F32, "router gradient")


def _experts(g, n, d=64, f=32):
    return (torch.randn((n, 2 * f, d), generator=g) * 0.2,
            torch.randn((n, d, f), generator=g) * 0.2)


def case_dropless_imbalanced():
    """The dropless layer under forced imbalance: every token picks held
    expert 0, none picks held expert 3, the rest spread over all eight.
    Each held pick is computed (the output equals the sum over every pick
    of a held expert, computed one pair at a time), the others add
    nothing, and the tally counts each held expert's rows."""
    g = torch.Generator().manual_seed(3)
    tokens, k = 40, 3
    x = torch.randn((tokens, 64), generator=g)
    rest = torch.tensor([1, 2, 4, 5, 6, 7])
    idx = torch.stack([torch.zeros(tokens, dtype=torch.long),
                       rest[torch.randint(0, 6, (tokens,), generator=g)],
                       rest[torch.randint(0, 6, (tokens,), generator=g)]], 1)
    idx[:, 2] = torch.where(idx[:, 2] == idx[:, 1], 4 + (idx[:, 1] == 4),
                            idx[:, 2])
    w = torch.rand((tokens, k), generator=g)
    gu, dn = _experts(g, 4)
    metrics.reset()
    y = moe.held_experts(x, idx, w, gu, dn, 0, layer="imbalanced")
    want = torch.zeros_like(x)
    for t in range(tokens):
        for j in range(k):
            e = int(idx[t, j])
            if e < 4:
                want[t] += w[t, j] * ref.swiglu(x[t], gu[e], dn[e],
                                                lowp.FP32)
    _close(y, want, F32, "output")
    metrics.snapshot()
    rows = {int(dict(key)["expert"]): v for key, v in
            metrics.MOE_EXPERT_ROWS.series().items()
            if dict(key)["layer"] == "imbalanced"}
    assert rows == {e: float((idx == e).sum()) for e in range(4)}
    assert rows[0] == tokens and rows[3] == 0
    imb = metrics.MOE_EXPERT_IMBALANCE.value({"layer": "imbalanced"})
    assert imb == pytest.approx(tokens / (sum(rows.values()) / 4))


def case_shares_add_up():
    """The share test: the routed parts that the two shares of four
    experts give, plus the shared experts once, equal the uncut
    reference layer over all eight experts; output and the gradients of
    the input, the router and every expert."""
    cfg = small_config(n_routed_experts=8)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 20, 64), generator=g)
    ct = torch.randn((2, 20, 64), generator=g)
    gu, dn = _experts(g, 8)
    router = torch.randn((8, 64), generator=g) * 0.3
    sgu, sdn = (torch.randn((128, 64), generator=g) * 0.2,
                torch.randn((64, 64), generator=g) * 0.2)
    pre = "blocks.1.mlp."
    p = {pre + "router.weight": router, pre + "w_gate_up": gu,
         pre + "w_down": dn, pre + "shared.gate_up.weight": sgu,
         pre + "shared.down.weight": sdn}
    p = {n: t.clone().requires_grad_() for n, t in p.items()}
    xr = x.clone().requires_grad_()
    want, _ = ref.moe(xr, p, pre, cfg, lowp.FP32)
    want.backward(ct)

    xp = x.clone().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (router, gu, dn, sgu, sdn)]
    rp, gup, dnp, sgup, sdnp = leaves
    flat = xp.reshape(40, 64)
    idx, w, _ = moe.route_sigmoid_top_k(flat @ rp.t(), torch.zeros(8), 3,
                                        cfg["routed_scaling_factor"])
    parts = [moe.held_experts(flat, idx, w, gup[s:s + 4], dnp[s:s + 4], s)
             for s in (0, 4)]
    shared = ref.swiglu(flat, sgup, sdnp, lowp.FP32)
    got = (sum(parts) + shared).view(2, 20, 64)
    got.backward(ct)
    _close(got, want, F32, "output")
    _close(xp.grad, xr.grad, F32, "dx")
    for name, leaf in zip(("router.weight", "w_gate_up", "w_down",
                           "shared.gate_up.weight", "shared.down.weight"),
                          leaves):
        _close(leaf.grad, p[pre + name].grad, F32, name)


def case_balance_loss():
    """The sequence-wise balance loss of a batch of three sequences (the
    port's mean over sequences) against the reference's, one sequence at
    a time, and its gradient through the scores; and 1 where the picks
    and the scores are even."""
    g = torch.Generator().manual_seed(5)
    logits = torch.randn((3 * 16, 8), generator=g)
    lp = logits.clone().requires_grad_()
    idx, _, scores = moe.route_sigmoid_top_k(lp, torch.zeros(8), 3)
    got = moe.sequence_balance_loss(scores, idx, 3)
    got.backward()
    lr = logits.clone().requires_grad_()
    s = torch.sigmoid(lr)
    want = sum(ref.balance_loss(s[i * 16:(i + 1) * 16],
                                idx[i * 16:(i + 1) * 16])
               for i in range(3)) / 3
    want.backward()
    _close(got, want, F32, "loss")
    _close(lp.grad, lr.grad, F32, "gradient")
    # eight tokens of one sequence, each expert picked twice, even scores
    even = torch.stack([torch.arange(8), (torch.arange(8) + 4) % 8], 1)
    flat = moe.sequence_balance_loss(torch.ones(8, 8), even, 1)
    assert flat.item() == pytest.approx(1.0)


CASES = {"mla": case_mla, "router": case_router,
         "dropless_imbalanced": case_dropless_imbalanced,
         "shares_add_up": case_shares_add_up,
         "balance_loss": case_balance_loss}


@pytest.mark.parametrize("case", list(CASES))
def test_part_matches_reference(case):
    CASES[case]()


# --------------------------------------------------------------------------
# the whole model: loss, every leaf's gradient, one Adam step
# --------------------------------------------------------------------------


def _program_step(cfg, tokens):
    model = family.build(cfg, SEED, "cpu")
    loss = family.loss(model, tokens)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt = family.optimizer(cfg, model)
    opt.step()
    return loss, grads, dict(model.named_parameters())


def _reference_step(cfg, tokens):
    p = _ref_params(cfg)
    total = 0.0
    for piece, share in ref.micro_batches(tokens):
        loss = ref.loss(p, piece, cfg)
        (loss * share).backward()
        total = total + loss.detach() * share
    grads = {n: t.grad.clone() for n, t in p.items()}
    params = {n: t.detach().clone() for n, t in p.items()}
    ref_train._adam(params, grads, {}, 1, cfg["optimizer"])
    return total, grads, params


@pytest.mark.parametrize("attn_mode", ["ulysses", "ring", "ring_zigzag"])
def test_model_step_matches_reference(attn_mode):
    """Three layers (dense, then two expert layers holding 4 of 8
    experts), float32, each attention mode over a sequence group of one:
    the loss and every leaf's gradient within ``F32`` of the reference,
    and the weights after one Adam step within ``ADAM_STEP`` of lr (the
    first step moves an entry by ``lr g / (|g| + eps)``: lr where the
    gradient is large, but an entry whose gradient is near eps, 1e-8,
    moves by a share of lr that a float32 difference in g of ``F32`` of
    the leaf's largest entry can change by about 1e-3)."""
    cfg = small_config(attn_mode=attn_mode)
    tokens = _tokens(cfg)
    loss, grads, params = _program_step(cfg, tokens)
    rloss, rgrads, rparams = _reference_step(cfg, tokens)
    assert set(grads) == set(rgrads)
    assert loss.item() == pytest.approx(rloss.item(), rel=F32)
    for name in grads:
        _close(grads[name], rgrads[name], F32, name)
        err = (params[name].detach() - rparams[name]).abs().max()
        assert err <= ADAM_STEP * cfg["optimizer"]["lr"], name


def test_model_bf16_loss_near_reference():
    """The card's dtype on the CPU (bf16 products through the plain flash
    path and the grouped GEMM): the loss within ``BF16_LOSS`` of the
    float32 reference's, and every leaf gets a finite gradient."""
    cfg = small_config(compute_dtype="bfloat16")
    tokens = _tokens(cfg)
    model = family.build(cfg, SEED, "cpu")
    loss = family.loss(model, tokens)
    loss.backward()
    rloss, _, _ = _reference_step(small_config(), tokens)
    assert loss.item() == pytest.approx(rloss.item(), rel=BF16_LOSS)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_model_refuses_an_expert_group_it_cannot_exchange_over(
        monkeypatch):
    """The layer exchanges no tokens, so an expert group of more than one
    rank is refused at build time, not trained wrongly."""
    monkeypatch.setattr(tds, "group_size", lambda group: 2)
    cfg = tds.DeepseekV3Config(
        vocab_size=128, hidden_size=64, num_layers=2, intermediate_size=96,
        moe_intermediate_size=32, n_routed_experts=8, n_held_experts=4,
        experts_per_token=3, num_heads=2, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="expert group"):
        tds.DeepseekV3LM(cfg, device="cpu", expert_group=object())


def test_reset_parameters_draws_every_weight():
    """A model built outside the benchmark starts from drawn weights: every
    matrix normal with the published std 0.02 (the held experts too, which
    are built empty), every RMSNorm scale 1, and the same seed draws the
    same weights."""
    cfg = family.model_config(small_config())
    a, b = (tds.DeepseekV3LM(cfg, device="cpu").reset_parameters(
        torch.Generator().manual_seed(3)) for _ in range(2))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if p.dim() == 1:
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert p.std().item() == pytest.approx(0.02, rel=0.2), name


def test_rope_pairs_as_published():
    """RoPE rotates the interleaved pairs (2i, 2i+1) of the published
    layout by ``pos * theta^(-2i/r)`` and lays the result out as halves:
    against a rotation written pair by pair, for q (one per head) and for
    the shared key; the reference's the same."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn((1, 5, 2, 8), generator=g)
    got = tds.rope(x, torch.arange(5), 50000.0)
    want = torch.empty_like(x)
    for pos in range(5):
        for i in range(4):
            a = pos * 50000.0 ** (-2 * i / 8)
            c, s = math.cos(a), math.sin(a)
            x0, x1 = x[0, pos, :, 2 * i], x[0, pos, :, 2 * i + 1]
            want[0, pos, :, i] = x0 * c - x1 * s
            want[0, pos, :, 4 + i] = x1 * c + x0 * s
    _close(got, want, 1e-6, "port")
    _close(ref.rope(x, 50000.0), want, 1e-6, "reference")


def test_flops_count_the_expected_share_of_picks():
    """The family's model operations: 6 per matmul parameter a token meets,
    the held experts at num_experts_per_tok x held / routed evaluations a
    token (0.75 at 6 x 8 / 64), and causal attention at the two widths."""
    cfg = json.loads((REPO / "perfbench/configs/moonlight-16b-a3b.json")
                     .read_text())
    per_token = family.matmul_params_per_token(cfg)
    d, f = 2048, 1408
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    moe_layer = 3 * d * f * (0.75 + 2) + d * 64
    assert per_token == 9 * attn + 3 * d * 11264 + 8 * moe_layer + d * 20480
    traffic = {"batch_per_rank": 4, "seq_len": 8192}
    pairs = 8192 * 8193 // 2
    assert family.flops_per_step(cfg, traffic) == pytest.approx(
        6 * per_token * 32768 + 6 * 320 * pairs * 16 * 9 * 4)
    work = family.flash_launch(cfg, traffic)
    assert work["flash_fwd"][0] == 2 * 320 * 64 * pairs
    assert work["flash_bwd_dkv"][0] == 4 * 320 * 64 * pairs
