"""GPT-style Transformer LM (port of ``horovod_tpu/models/transformer.py``).

The same model as the flax one, as ``nn.Module``s: float32 parameters with
compute in ``cfg.dtype`` (bfloat16 by default), LayerNorm statistics in
float32 with epsilon 1e-6, tanh-approximated GELU, and float32 logits.
Attention is ``"full"`` (plain PyTorch), or one of the sequence-parallel
modes on the flash kernels: ``"ring"`` and ``"ring_zigzag"``
(:func:`horovod_tpu_torch.parallel.sequence.ring_attention`) and
``"ulysses"`` (:func:`~horovod_tpu_torch.parallel.sequence.ulysses_attention`).
In those the model runs on this rank's block of the sequence, over the
sequence group given as ``seq_group`` (a ``torch.distributed`` group; None
is this rank alone), and positions are offset by the group rank times the
block length. With ``moe_experts > 0`` each block's MLP is the
expert-parallel MoE FFN (:class:`MoeMLP`) over the expert group given as
``expert_group``, one expert a rank. :func:`from_flax_params` carries the
JAX package's weights across.

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
from ..parallel.moe import moe_alltoall
from ..parallel.sequence import (group_rank, group_size, ring_attention,
                                 ulysses_attention)

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
    # "full" (exact local attention in plain PyTorch), or on the flash
    # kernels over the model's sequence group: "ring", "ring_zigzag" (the
    # causal load-balanced zigzag schedule) or "ulysses"
    attn_mode: str = "full"
    # expert parallelism: moe_experts > 0 replaces the dense MLP with the
    # expert-parallel MoE FFN over the model's expert group, whose size
    # must be moe_experts (one expert a rank)
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25

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
    def __init__(self, cfg: TransformerConfig, device=None, seq_group=None):
        super().__init__()
        self.cfg = cfg
        self.seq_group = seq_group
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
        if cfg.attn_mode in RING_SCHEDULES:
            out = ring_attention(q, k, v, self.seq_group, causal=True,
                                 schedule=RING_SCHEDULES[cfg.attn_mode])
        elif cfg.attn_mode == "ulysses":
            out = ulysses_attention(q, k, v, self.seq_group, causal=True)
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


class MoeMLP(nn.Module):
    """Expert-parallel MoE FFN (JAX ``MoeMLP``): one expert a rank of
    ``expert_group``, routed by :func:`~horovod_tpu_torch.parallel.moe.
    moe_alltoall`.

    The router is float32. The expert weights are stored replicated,
    ``w_in`` (n_experts, d, d_ff) and ``w_out`` (n_experts, d_ff, d) in
    float32, and each rank selects its own expert. Only that slice gets a
    gradient on a rank, so its gradient is pre-scaled by n_experts (the
    forward-identical ``w * n - w.detach() * (n - 1)``): the AVERAGE
    gradient sync then yields each expert's own gradient, with no special
    case in the optimizer. Each forward leaves the block's Switch
    load-balance loss in :attr:`aux` (the reference sows it under
    ``("intermediates", "moe_aux")``); ``TransformerLM.moe_aux_loss()``
    sums it over the blocks."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 expert_group=None):
        super().__init__()
        self.cfg = cfg
        self.expert_group = expert_group
        device = runtime.default_device(device)
        n_e, d = cfg.moe_experts, cfg.d_model
        self.router = Dense(d, n_e, torch.float32, device)
        self.w_in = nn.Parameter(torch.empty((n_e, d, cfg.d_ff),
                                             device=device))
        self.w_out = nn.Parameter(torch.empty((n_e, cfg.d_ff, d),
                                              device=device))
        self.aux = None

    def forward(self, x):
        cfg, n_e = self.cfg, self.cfg.moe_experts
        b, s, d = x.shape
        flat = x.reshape(b * s, d).to(cfg.dtype)
        logits = self.router(flat)
        e = group_rank(self.expert_group)

        def grad_boost(w):
            # forward-identical up to one rounding step, backward x n
            return w * n_e - w.detach() * (n_e - 1)

        def expert_fn(t):
            h = F.gelu(t @ grad_boost(self.w_in[e]).to(t.dtype),
                       approximate="tanh")
            return h @ grad_boost(self.w_out[e]).to(t.dtype)

        y, self.aux = moe_alltoall(
            flat, logits, expert_fn, self.expert_group, k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor)
        return y.reshape(b, s, d).to(cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, seq_group=None,
                 expert_group=None):
        super().__init__()
        device = runtime.default_device(device)
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.attn = Attention(cfg, device, seq_group)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.mlp = (MoeMLP(cfg, device, expert_group) if cfg.moe_experts > 0
                    else MLP(cfg, device))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """Token ids (batch, seq) -> float32 logits (batch, seq, vocab). In a
    sequence-parallel ``attn_mode`` the tokens are this rank's block of the
    sequence, block r of the ranks of ``seq_group``. With ``moe_experts >
    0`` the blocks' MoE FFNs route over ``expert_group``, whose size must be
    ``moe_experts``; add ``0.01 * moe_aux_loss()`` to the objective, as the
    reference trainer does."""

    def __init__(self, cfg: TransformerConfig, device=None, seq_group=None,
                 expert_group=None):
        super().__init__()
        self.cfg = cfg
        self.seq_group = seq_group
        if cfg.moe_experts > 0 and group_size(expert_group) != \
                cfg.moe_experts:
            raise ValueError(
                f"moe_experts={cfg.moe_experts} needs an expert group of "
                f"that size, got {group_size(expert_group)} ranks")
        device = runtime.default_device(device)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.d_model,
                                      device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, device, seq_group, expert_group)
            for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's default initializers, drawn on the host from the CPU
        ``generator`` (so a seed gives the same weights on any device):
        embeddings normal with std 1/sqrt(d_model), dense kernels normal
        with std 1/sqrt(fan_in), LayerNorm scale 1 and bias 0. flax's
        ``lecun_normal`` counts the leading dim of a 3-D kernel as its
        receptive field, so an expert weight's fan-in is ``n_experts * d``
        (``w_in``) or ``n_experts * d_ff`` (``w_out``)."""
        for name, p in self.named_parameters():
            if name.endswith(("ln1.weight", "ln2.weight", "ln_f.weight")):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                # Linear: in_features; Embedding: d; experts: n_e * d or
                # n_e * d_ff
                fan_in = math.prod(p.shape[:2]) if p.dim() == 3 else p.shape[1]
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(fan_in))
        return self

    def forward(self, tokens):
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        if cfg.attn_mode in SEQ_PARALLEL_MODES:
            # this rank holds block r of the sequence
            block = group_rank(self.seq_group) * tokens.shape[1]
            positions = positions + block
        x = self.embed(tokens).to(cfg.dtype)
        x = x + self.pos_embed(positions).to(cfg.dtype)[None]
        for block in self.blocks:
            x = block(x)
        return self.lm_head(self.ln_f(x)).float()

    def moe_aux_loss(self):
        """The sum over the blocks of the load-balance losses of the last
        forward (0 without MoE blocks)."""
        return sum(b.mlp.aux for b in self.blocks
                   if isinstance(b.mlp, MoeMLP))


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
        if "moe_mlp" in blk:
            moe, pre = blk["moe_mlp"], pre + "mlp."
            sd[pre + "router.weight"] = dense(moe["router"]["kernel"])
            sd[pre + "w_in"] = t(moe["w_in"])
            sd[pre + "w_out"] = t(moe["w_out"])
        else:
            sd[pre + "mlp.wi.weight"] = dense(blk["mlp"]["wi"]["kernel"])
            sd[pre + "mlp.wo.weight"] = dense(blk["mlp"]["wo"]["kernel"])
        i += 1
    return sd
