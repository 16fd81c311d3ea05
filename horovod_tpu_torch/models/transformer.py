"""GPT-style Transformer LM (port of ``horovod_tpu/models/transformer.py``).

The same model as the flax one, as ``nn.Module``s: float32 parameters with
compute in ``cfg.dtype`` (bfloat16 by default), LayerNorm statistics in
float32 with epsilon 1e-6, tanh-approximated GELU, and float32 logits.
Attention is ``"full"`` (plain PyTorch) or ``"ulysses"`` (the flash kernels,
through :func:`horovod_tpu_torch.parallel.sequence.ulysses_attention` over a
sequence group of one rank). :func:`from_flax_params` carries the JAX
package's weights across.

Every module is built on ``device`` when one is given, else on
:func:`horovod_tpu_torch.runtime.default_device`: the device of ``init()``'s
world, or the current card. Pass ``device="cpu"`` for a model on the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime
from ..parallel.sequence import ulysses_attention

RING_SCHEDULES = {"ring": "contiguous", "ring_zigzag": "zigzag"}
SEQ_PARALLEL_MODES = tuple(RING_SCHEDULES) + ("ulysses",)
ATTN_MODES = ("full",) + SEQ_PARALLEL_MODES


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    d_model: int = 512
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # "full" (exact local attention in plain PyTorch) or "ulysses" (the
    # flash kernels); "ring"/"ring_zigzag" are ROADMAP item A7
    attn_mode: str = "full"
    moe_experts: int = 0  # expert-parallel MoE FFN: ROADMAP item A9

    def __post_init__(self):
        # An unknown mode would silently fall through to full LOCAL
        # attention per shard — training runs, logits are wrong.
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(
                f"unknown attn_mode {self.attn_mode!r}; valid: "
                f"{ATTN_MODES}")


class Dense(nn.Linear):
    """Bias-free ``nn.Linear`` with float32 weights that computes in
    ``dtype`` (flax ``Dense(dtype=..., param_dtype=float32)``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__(in_features, out_features, bias=False,
                         device=runtime.default_device(device),
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: statistics in float32, epsilon 1e-6, output in
    ``dtype``."""

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__(d, eps=1e-6, device=runtime.default_device(device),
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        if cfg.attn_mode in RING_SCHEDULES:
            raise NotImplementedError(
                f"attn_mode={cfg.attn_mode!r} is not ported yet (ROADMAP.md "
                "queue A, item A7)")
        self.cfg = cfg
        device = runtime.default_device(device)
        self.head_dim = cfg.d_model // cfg.num_heads
        inner = cfg.num_heads * self.head_dim
        self.q = Dense(cfg.d_model, inner, cfg.dtype, device)
        self.k = Dense(cfg.d_model, inner, cfg.dtype, device)
        self.v = Dense(cfg.d_model, inner, cfg.dtype, device)
        self.o = Dense(inner, cfg.d_model, cfg.dtype, device)

    def forward(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = (b, s, cfg.num_heads, self.head_dim)
        q = self.q(x).view(heads)
        k = self.k(x).view(heads)
        v = self.v(x).view(heads)
        if cfg.attn_mode == "ulysses":
            out = ulysses_attention(q, k, v, causal=True)
        else:
            q = q / torch.tensor(math.sqrt(self.head_dim)).to(cfg.dtype)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
            future = torch.ones((s, s), dtype=torch.bool,
                                device=x.device).triu(1)
            logits = logits.masked_fill(future, torch.finfo(torch.float32).min)
            probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.o(out.reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        device = runtime.default_device(device)
        self.wi = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, device)
        self.wo = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, device)

    def forward(self, x):
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "moe_experts > 0 is not ported yet (ROADMAP.md queue A, "
                "item A9)")
        device = runtime.default_device(device)
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """Token ids (batch, seq) -> float32 logits (batch, seq, vocab)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = runtime.default_device(device)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.d_model,
                                      device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's default initializers, drawn on the host from the CPU
        ``generator`` (so a seed gives the same weights on any device):
        embeddings normal with std 1/sqrt(d_model), dense kernels normal
        with std 1/sqrt(fan_in), LayerNorm scale 1 and bias 0."""
        for name, p in self.named_parameters():
            if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                fan_in = p.shape[1]  # Linear: in_features; Embedding: d
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(fan_in))
        return self

    def forward(self, tokens):
        cfg = self.cfg
        # A sequence group of one rank: positions start at 0 (the JAX model
        # offsets them by the group rank times the block length).
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens).to(cfg.dtype)
        x = x + self.pos_embed(positions).to(cfg.dtype)[None]
        for block in self.blocks:
            x = block(x)
        return self.lm_head(self.ln_f(x)).float()


def lm_loss(logits, tokens):
    """Next-token cross-entropy over all but the last position (the loss of
    ``examples/long_context_lm.py``)."""
    tgt = torch.roll(tokens, -1, dims=1)
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tgt[..., None])[:, :-1].mean()


def from_flax_params(params) -> dict:
    """A ``state_dict`` for :class:`TransformerLM` from the JAX model's
    ``params`` tree (nested dicts of arrays, e.g. numpy). flax ``Dense``
    kernels are (in, out) and ``DenseGeneral`` q/k/v kernels (d_model,
    heads, head_dim), o kernels (heads, head_dim, d_model); ``nn.Linear``
    weights are (out, in)."""

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def dense(kernel, n_in_axes=1):
        k = np.asarray(kernel, np.float32)
        rows = int(np.prod(k.shape[:n_in_axes]))
        return t(k.reshape(rows, -1).T)

    sd = {"embed.weight": t(params["embed"]["embedding"]),
          "pos_embed.weight": t(params["pos_embed"]["embedding"]),
          "ln_f.weight": t(params["ln_f"]["scale"]),
          "ln_f.bias": t(params["ln_f"]["bias"]),
          "lm_head.weight": dense(params["lm_head"]["kernel"])}
    i = 0
    while f"block_{i}" in params:
        blk, pre = params[f"block_{i}"], f"blocks.{i}."
        for flax_ln, ln in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            sd[pre + ln + ".weight"] = t(blk[flax_ln]["scale"])
            sd[pre + ln + ".bias"] = t(blk[flax_ln]["bias"])
        for name in ("q", "k", "v"):
            sd[pre + f"attn.{name}.weight"] = dense(blk["attn"][name]["kernel"])
        sd[pre + "attn.o.weight"] = dense(blk["attn"]["o"]["kernel"], 2)
        sd[pre + "mlp.wi.weight"] = dense(blk["mlp"]["wi"]["kernel"])
        sd[pre + "mlp.wo.weight"] = dense(blk["mlp"]["wo"]["kernel"])
        i += 1
    return sd
