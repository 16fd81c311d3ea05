"""DeepSeek-V3-style LM: multi-head latent attention and a dropless
expert layer (Moonlight-16B-A3B, DeepSeek-V3's report arXiv:2412.19437
§2.1). The JAX package has no such model; the port's is its own.

Per block, with ``h`` the block's normed input (RMSNorm, float32
statistics):

* **MLA**: ``q = W_q h``, heads of ``[q_nope | q_rope]``; ``[c | k_rope] =
  W_kva h`` and ``c <- RMSNorm(c)``; ``[k_nope | v] = W_kvb c`` a head;
  RoPE on ``q_rope`` and on ``k_rope``, one key shared by all heads (pairs
  as the published modeling code pairs them: interleaved in, halves out);
  ``k = [k_nope | k_rope]``; causal softmax at scale ``1/sqrt(d_qk)``
  through the flash kernels (:func:`~horovod_tpu_torch.parallel.sequence.
  ulysses_attention` or the ring, over ``seq_group``), v narrower than q and
  k; ``W_o`` over the heads.
* **FFN**: the first ``first_k_dense`` blocks a SwiGLU MLP; the rest the
  dropless expert layer (:class:`MoE`): a float32 sigmoid router over all
  ``n_routed_experts`` with a correction bias that steers the choice
  (a buffer, held at zero: nothing updates it between steps), the top
  ``experts_per_token``, weights ``s / sum(s) * routed_scaling_factor``;
  the experts this rank holds run through
  :func:`~horovod_tpu_torch.parallel.moe.held_experts`, and the shared
  experts (one SwiGLU of ``n_shared_experts`` times the expert width) on
  every token.
* ``x + MLA(RMSNorm x)``, then ``+ FFN(RMSNorm .)``; a final RMSNorm and an
  untied head, float32 logits.

Parameters are float32; products run in ``cfg.dtype`` (bf16 by default).
Each expert layer leaves its sequence-wise balance loss (before alpha) in
``aux``; :meth:`DeepseekV3LM.balance_loss` gives ``alpha`` times their sum,
to add to the objective. A rank of ``expert_group`` holds the experts
``[r n_held, (r + 1) n_held)``; a group of one (None) holds the first
``n_held``, and only their part of each expert layer's output goes on, as
on one chip of a deployment that divides each layer's experts over
``n_routed_experts / n_held`` chips.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import runtime
from ..parallel.moe import (held_experts, route_sigmoid_top_k,
                            sequence_balance_loss)
from ..parallel.sequence import (group_rank, group_size, ring_attention,
                                 ulysses_attention)
from .transformer import RING_SCHEDULES, SEQ_PARALLEL_MODES, Dense


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_layers: int = 27
    first_k_dense: int = 1
    intermediate_size: int = 11264   # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408  # one expert's
    n_routed_experts: int = 64
    n_held_experts: int = 64         # routed experts a rank holds
    experts_per_token: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    balance_alpha: float = 1e-4      # the sequence-wise balance loss's
    dtype: torch.dtype = torch.bfloat16
    attn_mode: str = "ulysses"       # on the flash kernels: or a ring mode

    def __post_init__(self):
        if self.attn_mode not in SEQ_PARALLEL_MODES:
            raise ValueError(f"unknown attn_mode {self.attn_mode!r}; valid: "
                             f"{SEQ_PARALLEL_MODES}")
        if self.n_routed_experts % self.n_held_experts:
            raise ValueError(f"{self.n_held_experts} held experts do not "
                             f"divide {self.n_routed_experts}")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


class _RMSNorm(torch.autograd.Function):
    """``x / sqrt(mean(x^2) + eps) * w`` in float32, out in ``dtype``.
    Saves ``x`` as it came (the block keeps it anyway) and one float32 a
    row, where autograd over the op chain would keep two float32 copies of
    ``x``: on the card at 32768 tokens, over a gigabyte a layer."""

    @staticmethod
    def forward(ctx, x, w, eps, dtype):
        xf = x.float()
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, w, r)
        return (xf * r * w).to(dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, r = ctx.saved_tensors
        n = x.float() * r
        dy = dy.float()
        dw = (dy * n).reshape(-1, n.shape[-1]).sum(0)
        dn = dy * w
        dx = r * (dn - n * (dn * n).mean(-1, keepdim=True))
        return dx.to(x.dtype), dw, None, None


class RMSNorm(nn.Module):
    """``x / sqrt(mean(x^2) + eps) * weight`` in float32, out in ``dtype``."""

    def __init__(self, d: int, eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(
            d, device=runtime.default_device(device)))
        self.eps, self.compute_dtype = eps, dtype

    def forward(self, x):
        return _RMSNorm.apply(x, self.weight, self.eps, self.compute_dtype)


def rope(x, positions, theta: float):
    """Rotary embedding of (b, s, h, r) by the (s,) ``positions``, as the
    published DeepSeek-V3 code applies it: the interleaved pairs (2i, 2i+1)
    are taken apart into halves, then rotated by ``pos * theta^(-2i/r)``;
    in float32, out in ``x``'s dtype."""
    b, s, h, r = x.shape
    inv = theta ** (-torch.arange(0, r, 2, device=x.device,
                                  dtype=torch.float32) / r)
    ang = positions.float()[:, None] * inv[None]  # (s, r / 2)
    cos = torch.cat((ang, ang), -1).cos()[None, :, None]
    sin = torch.cat((ang, ang), -1).sin()[None, :, None]
    xf = x.float().view(b, s, h, r // 2, 2).transpose(-1, -2).reshape(
        b, s, h, r)
    rot = torch.cat((-xf[..., r // 2:], xf[..., :r // 2]), -1)
    return (xf * cos + rot * sin).to(x.dtype)


class MLA(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, device=None, seq_group=None):
        super().__init__()
        self.cfg, self.seq_group = cfg, seq_group
        d, hd, dt = cfg.hidden_size, cfg.num_heads, cfg.dtype
        self.q = Dense(d, hd * cfg.qk_head_dim, dt, device)
        self.kv_a = Dense(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dt,
                          device)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, dt, device)
        self.kv_b = Dense(cfg.kv_lora_rank,
                          hd * (cfg.qk_nope_head_dim + cfg.v_head_dim), dt,
                          device)
        self.o = Dense(hd * cfg.v_head_dim, d, dt, device)

    def forward(self, x, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        h, nope, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q_nope, q_rope = self.q(x).view(b, s, h, nope + r).split([nope, r],
                                                                 -1)
        c, k_rope = self.kv_a(x).split([cfg.kv_lora_rank, r], -1)
        k_nope, v = self.kv_b(self.kv_norm(c)).view(
            b, s, h, nope + cfg.v_head_dim).split([nope, cfg.v_head_dim], -1)
        q_rope = rope(q_rope, positions, cfg.rope_theta)
        k_rope = rope(k_rope[:, :, None], positions, cfg.rope_theta)
        q = torch.cat((q_nope, q_rope), -1)
        k = torch.cat((k_nope, k_rope.expand(b, s, h, r)), -1)
        if cfg.attn_mode in RING_SCHEDULES:
            out = ring_attention(q, k, v, self.seq_group,
                                 causal=True,
                                 schedule=RING_SCHEDULES[cfg.attn_mode])
        else:
            out = ulysses_attention(q, k, v, self.seq_group, causal=True)
        return self.o(out.reshape(b, s, h * cfg.v_head_dim))


class SwiGLU(nn.Module):
    """``W_down (silu(W_gate x) * W_up x)``, gate and up as one matrix."""

    def __init__(self, d: int, width: int, dtype, device=None):
        super().__init__()
        self.width = width
        self.gate_up = Dense(d, 2 * width, dtype, device)
        self.down = Dense(width, d, dtype, device)

    def forward(self, x):
        h = self.gate_up(x)
        return self.down(F.silu(h[..., :self.width]) * h[..., self.width:])


class MoE(nn.Module):
    """The dropless expert layer: routes every token over all routed
    experts, computes the part its held experts give
    (:func:`~horovod_tpu_torch.parallel.moe.held_experts`), adds the shared
    experts. ``w_gate_up`` (n_held, 2 f, d) and ``w_down`` (n_held, d, f)
    hold the experts ``first .. first + n_held - 1``. Leaves the sequence-
    wise balance loss in :attr:`aux`."""

    def __init__(self, cfg: DeepseekV3Config, name: str, device=None,
                 expert_group=None):
        super().__init__()
        device = runtime.default_device(device)
        self.cfg, self.name = cfg, name
        d, f, n = cfg.hidden_size, cfg.moe_intermediate_size, \
            cfg.n_held_experts
        self.first = group_rank(expert_group) * n
        self.router = Dense(d, cfg.n_routed_experts, torch.float32, device)
        self.register_buffer("router_bias", torch.zeros(
            cfg.n_routed_experts, device=device))
        self.w_gate_up = nn.Parameter(torch.empty((n, 2 * f, d),
                                                  device=device))
        self.w_down = nn.Parameter(torch.empty((n, d, f), device=device))
        self.shared = SwiGLU(d, f * cfg.n_shared_experts, cfg.dtype, device)
        self.aux = None

    def forward(self, x):
        cfg = self.cfg
        b, s, d = x.shape
        flat = x.reshape(b * s, d).to(cfg.dtype)
        idx, w, scores = route_sigmoid_top_k(
            self.router(flat), self.router_bias, cfg.experts_per_token,
            cfg.routed_scaling_factor)
        self.aux = sequence_balance_loss(scores, idx, b)
        y = held_experts(flat, idx, w, self.w_gate_up.to(cfg.dtype),
                         self.w_down.to(cfg.dtype), self.first,
                         layer=self.name)
        return (y + self.shared(flat)).view(b, s, d)


class Block(nn.Module):
    def __init__(self, cfg: DeepseekV3Config, index: int, device=None,
                 seq_group=None, expert_group=None):
        super().__init__()
        eps, dt = cfg.rms_norm_eps, cfg.dtype
        self.attn_norm = RMSNorm(cfg.hidden_size, eps, dt, device)
        self.attn = MLA(cfg, device, seq_group)
        self.mlp_norm = RMSNorm(cfg.hidden_size, eps, dt, device)
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size, dt,
                           device) if index < cfg.first_k_dense
                    else MoE(cfg, f"blocks.{index}", device, expert_group))

    def forward(self, x, positions):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class DeepseekV3LM(nn.Module):
    """Token ids (batch, seq) -> float32 logits (batch, seq, vocab). In a
    sequence-parallel ``attn_mode`` the tokens are this rank's block of the
    sequence, block r of the ranks of ``seq_group``, and positions are
    offset by r times the block length. ``expert_group``'s size times
    ``n_held_experts`` must be ``n_routed_experts`` where it is given; the
    exchange of tokens between its ranks is not part of this model, so a
    group of more than one rank is refused."""

    def __init__(self, cfg: DeepseekV3Config, device=None, seq_group=None,
                 expert_group=None):
        super().__init__()
        if group_size(expert_group) > 1:
            raise NotImplementedError(
                "the dropless expert layer exchanges no tokens: it runs "
                "over an expert group of one rank")
        self.cfg, self.seq_group = cfg, seq_group
        device = runtime.default_device(device)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, i, device, seq_group, expert_group)
            for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype,
                            device)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, cfg.dtype,
                             device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None,
                         std: float = 0.02):
        """Normal weights of std ``std`` (the published initializer range)
        drawn on the host from ``generator``, RMSNorm scales 1."""
        for name, p in self.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * std)
        return self

    def forward(self, tokens):
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        positions = positions + group_rank(self.seq_group) * tokens.shape[1]
        x = self.embed(tokens).to(self.cfg.dtype)
        for block in self.blocks:
            x = block(x, positions)
        return self.lm_head(self.norm(x)).float()

    def balance_loss(self):
        """``alpha`` times the sum over the expert layers of their
        sequence-wise balance losses of the last forward (0 without
        them)."""
        return self.cfg.balance_alpha * sum(
            b.mlp.aux for b in self.blocks if isinstance(b.mlp, MoE))

