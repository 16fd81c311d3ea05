"""Plain reference of the ``transformer_lm`` family: a GPT-2 block as the
program computes it, in float32 with TF32 off.

Per layer: ``x += o(attn(ln1(x)))`` with causal softmax attention of
``n_head`` heads, then ``x += wo(gelu_tanh(wi(ln2(x))))``; token and
position embeddings in, a final LayerNorm and an untied head out; no bias
in any projection; next-token cross-entropy over all but the last
position. The configuration's ``departures`` list where this differs from
the published GPT-2 block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import lowp


def param_spec(cfg: dict) -> list:
    """``(name, shape, init)`` of every parameter, named as the program's
    ``state_dict`` names them. GPT-2's initialization: normal with std
    ``initializer_range``, the residual projections scaled by
    ``1 / sqrt(2 n_layer)``; LayerNorm scale 1, bias 0."""
    d, f, v = cfg["n_embd"], cfg["n_inner"], cfg["vocab_size"]
    std = cfg["initializer_range"]
    resid = std / math.sqrt(2 * cfg["n_layer"])
    spec = [("embed.weight", (v, d), ("normal", std)),
            ("pos_embed.weight", (cfg["n_positions"], d), ("normal", std))]
    for i in range(cfg["n_layer"]):
        b = f"blocks.{i}."
        spec += [(b + "ln1.weight", (d,), ("ones",)),
                 (b + "ln1.bias", (d,), ("zeros",)),
                 (b + "attn.q.weight", (d, d), ("normal", std)),
                 (b + "attn.k.weight", (d, d), ("normal", std)),
                 (b + "attn.v.weight", (d, d), ("normal", std)),
                 (b + "attn.o.weight", (d, d), ("normal", resid)),
                 (b + "ln2.weight", (d,), ("ones",)),
                 (b + "ln2.bias", (d,), ("zeros",)),
                 (b + "mlp.wi.weight", (f, d), ("normal", std)),
                 (b + "mlp.wo.weight", (d, f), ("normal", resid))]
    spec += [("ln_f.weight", (d,), ("ones",)),
             ("ln_f.bias", (d,), ("zeros",)),
             ("lm_head.weight", (v, d), ("normal", std))]
    return spec


def micro_batches(tokens):
    """One sequence at a time: rows do not interact."""
    n = tokens.shape[0]
    return [(tokens[i:i + 1], 1.0 / n) for i in range(n)]


def _attention(x, p, pre, cfg, precision):
    b, s, d = x.shape
    h = cfg["n_head"]
    hd = d // h

    def heads(w):
        return lowp.linear(x, p[pre + w], precision).view(
            b, s, h, hd).transpose(1, 2)

    q, k, v = heads("q.weight"), heads("k.weight"), heads("v.weight")
    scores = lowp.matmul(q, k.transpose(-1, -2), precision) / math.sqrt(hd)
    future = torch.ones((s, s), dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    out = lowp.matmul(probs, v, precision).transpose(1, 2).reshape(b, s, d)
    return lowp.linear(out, p[pre + "o.weight"], precision)


def logits(p, tokens, cfg, precision=lowp.FP32):
    eps = cfg["layer_norm_epsilon"]
    d = cfg["n_embd"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = F.embedding(tokens, p["embed.weight"]) + p["pos_embed.weight"][pos]
    for i in range(cfg["n_layer"]):
        b = f"blocks.{i}."
        y = F.layer_norm(x, (d,), p[b + "ln1.weight"], p[b + "ln1.bias"], eps)
        x = x + _attention(y, p, b + "attn.", cfg, precision)
        y = F.layer_norm(x, (d,), p[b + "ln2.weight"], p[b + "ln2.bias"], eps)
        y = F.gelu(lowp.linear(y, p[b + "mlp.wi.weight"], precision),
                   approximate="tanh")
        x = x + lowp.linear(y, p[b + "mlp.wo.weight"], precision)
    x = F.layer_norm(x, (d,), p["ln_f.weight"], p["ln_f.bias"], eps)
    return lowp.linear(x, p["lm_head.weight"], precision)


def loss(p, tokens, cfg, precision=lowp.FP32):
    """Mean next-token cross-entropy over positions ``0 .. s-2``."""
    z = logits(p, tokens, cfg, precision)
    return F.cross_entropy(z[:, :-1].reshape(-1, z.shape[-1]),
                           tokens[:, 1:].reshape(-1))
