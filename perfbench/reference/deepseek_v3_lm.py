"""Plain reference of the ``deepseek_v3_lm`` family: a DeepSeek-V3 block
(arXiv:2412.19437 §2.1; Moonlight-16B-A3B's ``config.json``) in float32
with TF32 off, one chip's share of it.

Per layer, ``h`` the layer's RMSNorm'd input:

* MLA: ``q = W_q h`` (heads of ``[q_nope | q_rope]``); ``[c | k_rope] =
  W_kva h``, ``c <- RMSNorm(c)``; ``[k_nope | v] = W_kvb c`` a head; RoPE
  (theta ``rope_theta``) on ``q_rope`` and on the one ``k_rope`` all heads
  share, its interleaved pairs taken apart into halves first, as the
  published modeling code does; causal softmax of ``[q_nope | q_rope] .
  [k_nope | k_rope]`` at scale ``1/sqrt(qk_nope + qk_rope)``, in blocks of
  ``QUERY_BLOCK`` queries; ``W_o`` over the heads' outputs.
* FFN: the first ``first_k_dense_replace`` layers ``W_down (silu(W_gate h)
  * W_up h)`` at ``intermediate_size``; the others: the router
  ``s = sigmoid(W_r h)`` in float32 over ``router_outputs`` experts, the
  top ``num_experts_per_tok`` of ``s + b`` (``b`` the correction bias, held
  at zero), weights ``s / sum(s) * routed_scaling_factor``; ``y = sum_i
  w_i E_i(h)`` over the picks of the ``n_routed_experts`` experts held here
  (the first ones), ``E_i`` a SwiGLU of ``moe_intermediate_size``; plus
  the shared experts, one SwiGLU ``n_shared_experts`` times as wide.
* ``x + MLA(RMSNorm x)``, then ``+ FFN(RMSNorm .)``; a final RMSNorm and an
  untied head over the vocabulary slice; next-token cross-entropy over all
  but the last position, plus ``balance_alpha`` times the sum over the
  expert layers of the sequence-wise balance loss (the report's eqs. 17-20:
  ``sum_i f_i P_i`` over the sequence's tokens).

Each layer is checkpointed and attention runs in query blocks, so that one
8192-token sequence in float32 fits on the card. The configuration's
``departures`` list where this differs from the published model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import lowp

QUERY_BLOCK = 1024  # queries a block of the attention's scores


def _dims(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "h": cfg["num_attention_heads"],
            "nope": cfg["qk_nope_head_dim"], "rope": cfg["qk_rope_head_dim"],
            "dv": cfg["v_head_dim"], "lora": cfg["kv_lora_rank"],
            "f": cfg["moe_intermediate_size"],
            "held": cfg["n_routed_experts"],
            "shared": cfg["moe_intermediate_size"] * cfg["n_shared_experts"]}


def param_spec(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, named as the program's
    ``state_dict`` names them: normal with std ``initializer_range`` for
    every matrix, RMSNorm scales 1. A held expert's gate and up
    projections are one (2 f, d) matrix, gate first."""
    g = _dims(cfg)
    d, h, v = g["d"], g["h"], cfg["vocab_size"]
    std = ("normal", cfg["initializer_range"])
    spec = [("embed.weight", (v, d), std)]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}."
        spec += [(b + "attn_norm.weight", (d,), ("ones",)),
                 (b + "attn.q.weight", (h * (g["nope"] + g["rope"]), d), std),
                 (b + "attn.kv_a.weight", (g["lora"] + g["rope"], d), std),
                 (b + "attn.kv_norm.weight", (g["lora"],), ("ones",)),
                 (b + "attn.kv_b.weight", (h * (g["nope"] + g["dv"]),
                                           g["lora"]), std),
                 (b + "attn.o.weight", (d, h * g["dv"]), std),
                 (b + "mlp_norm.weight", (d,), ("ones",))]
        if i < cfg["first_k_dense_replace"]:
            w = cfg["intermediate_size"]
            spec += [(b + "mlp.gate_up.weight", (2 * w, d), std),
                     (b + "mlp.down.weight", (d, w), std)]
        else:
            f, s = g["f"], g["shared"]
            spec += [(b + "mlp.w_gate_up", (g["held"], 2 * f, d), std),
                     (b + "mlp.w_down", (g["held"], d, f), std),
                     (b + "mlp.router.weight", (cfg["router_outputs"], d),
                      std),
                     (b + "mlp.shared.gate_up.weight", (2 * s, d), std),
                     (b + "mlp.shared.down.weight", (d, s), std)]
    spec += [("norm.weight", (d,), ("ones",)),
             ("lm_head.weight", (v, d), std)]
    return spec


def micro_batches(tokens):
    """One sequence at a time: rows do not interact, and the balance loss
    is a sequence's."""
    n = tokens.shape[0]
    return [(tokens[i:i + 1], 1.0 / n) for i in range(n)]


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """(b, s, h, r) rotated by position: pair i of the halves by ``pos *
    theta^(-2i/r)``, after the interleaved pairs are taken apart."""
    b, s, h, r = x.shape
    inv = theta ** (-torch.arange(0, r, 2, device=x.device,
                                  dtype=torch.float32) / r)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    ang = torch.cat((ang, ang), -1)[None, :, None]
    x = x.view(b, s, h, r // 2, 2).transpose(-1, -2).reshape(b, s, h, r)
    half = torch.cat((-x[..., r // 2:], x[..., :r // 2]), -1)
    return x * ang.cos() + half * ang.sin()


def swiglu(x, gate_up, down, precision):
    hg = lowp.linear(x, gate_up, precision)
    w = down.shape[-1]
    return lowp.linear(F.silu(hg[..., :w]) * hg[..., w:], down, precision)


def attention(x, p, pre, cfg, precision):
    g = _dims(cfg)
    b, s, _ = x.shape
    h, nope, r, dv = g["h"], g["nope"], g["rope"], g["dv"]
    q = lowp.linear(x, p[pre + "q.weight"], precision).view(b, s, h, nope + r)
    c, k_rope = lowp.linear(x, p[pre + "kv_a.weight"], precision).split(
        [g["lora"], r], -1)
    c = rms_norm(c, p[pre + "kv_norm.weight"], cfg["rms_norm_eps"])
    kv = lowp.linear(c, p[pre + "kv_b.weight"], precision).view(
        b, s, h, nope + dv)
    theta = cfg["rope_theta"]
    q = torch.cat((q[..., :nope], rope(q[..., nope:], theta)), -1)
    k_rope = rope(k_rope[:, :, None], theta).expand(b, s, h, r)
    k = torch.cat((kv[..., :nope], k_rope), -1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, kv[..., nope:]))
    scale = 1.0 / math.sqrt(nope + r)
    outs = []
    for q0 in range(0, s, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, s)  # keys past q1 are all in the future
        sc = lowp.matmul(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2),
                         precision) * scale
        future = torch.ones((q1 - q0, q1), dtype=torch.bool,
                            device=x.device).triu(q0 + 1)
        probs = torch.softmax(sc.masked_fill(future, float("-inf")), -1)
        outs.append(lowp.matmul(probs, v[:, :, :q1], precision))
    out = torch.cat(outs, 2).transpose(1, 2).reshape(b, s, h * dv)
    return lowp.linear(out, p[pre + "o.weight"], precision)


def route(x, router, cfg):
    """(expert index, weight, score) of each token's picks, float32."""
    scores = torch.sigmoid(x @ router.t())
    bias = torch.zeros(scores.shape[-1], device=x.device)  # held at zero
    idx = torch.topk(scores + bias, cfg["num_experts_per_tok"],
                     dim=-1).indices
    w = scores.gather(-1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    return idx, w, scores


def balance_loss(scores, idx):
    """The sequence-wise balance loss of one sequence's (T, N) scores."""
    t, n = scores.shape
    k = idx.shape[-1]
    f = torch.zeros(n, device=scores.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=scores.device))
    f = f * n / (k * t)
    pm = (scores / scores.sum(-1, keepdim=True)).mean(0)
    return (f * pm).sum()


def moe(x, p, pre, cfg, precision, first: int = 0):
    """The expert layer's output from the experts held here, numbered
    ``first`` on, plus the shared experts; and the balance loss."""
    g = _dims(cfg)
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    idx, w, scores = route(flat, p[pre + "router.weight"], cfg)
    y = torch.zeros_like(flat)
    for e in range(g["held"]):
        tok, pick = torch.nonzero(idx == first + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(flat[tok], p[pre + "w_gate_up"][e],
                     p[pre + "w_down"][e], precision)
        y = y.index_add(0, tok, out * w[tok, pick, None])
    y = y + swiglu(flat, p[pre + "shared.gate_up.weight"],
                   p[pre + "shared.down.weight"], precision)
    return y.view(b, s, d), balance_loss(scores, idx)


def _layer(i, cfg, precision, p, x):
    pre, eps = f"blocks.{i}.", cfg["rms_norm_eps"]
    x = x + attention(rms_norm(x, p[pre + "attn_norm.weight"], eps), p,
                      pre + "attn.", cfg, precision)
    y = rms_norm(x, p[pre + "mlp_norm.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        return x + swiglu(y, p[pre + "mlp.gate_up.weight"],
                          p[pre + "mlp.down.weight"], precision), \
            torch.zeros((), device=x.device)
    y, aux = moe(y, p, pre + "mlp.", cfg, precision)
    return x + y, aux


def loss(p, tokens, cfg, precision=lowp.FP32):
    """Mean next-token cross-entropy over positions ``0 .. s-2`` of one
    sequence, plus ``balance_alpha`` times the expert layers' balance
    losses."""
    x = F.embedding(tokens, p["embed.weight"])
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["num_hidden_layers"]):
        x, a = checkpoint(_layer, i, cfg, precision, p, x,
                          use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, p["norm.weight"], cfg["rms_norm_eps"])
    z = lowp.linear(x, p["lm_head.weight"], precision)
    ce = F.cross_entropy(z[:, :-1].reshape(-1, z.shape[-1]),
                         tokens[:, 1:].reshape(-1))
    return ce + cfg["balance_alpha"] * aux
