"""Ulysses sequence-parallel attention over the flash kernels (port of the
Ulysses and local-flash parts of ``horovod_tpu/parallel/sequence.py``).

The port runs a sequence group of one rank: the all-to-alls that trade the
sequence split for a head split are the identity, and attention is the
local flash path, forward through ``flash_fwd`` and backward through
``flash_bwd_dq`` and ``flash_bwd_dkv``. A group of several ranks, and ring
and zigzag attention, are ROADMAP item A7.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import flash
from ..ops.flash import NEG_INF


def _group_size(group) -> int:
    """``group=None`` is this rank alone; else the size of the
    ``torch.distributed`` group."""
    return 1 if group is None else dist.get_world_size(group)


def _require_single(group, what: str) -> None:
    if _group_size(group) > 1:
        raise NotImplementedError(
            f"{what} over a sequence group of more than one rank is not "
            "ported yet (ROADMAP.md queue A, item A7)")


def seq_to_heads(x, group=None):
    """All-to-all reshard (batch, seq/n, heads, d) -> (batch, seq,
    heads/n, d); the identity for a group of one rank."""
    _require_single(group, "seq_to_heads")
    return x


def heads_to_seq(x, group=None):
    """Inverse of :func:`seq_to_heads`."""
    _require_single(group, "heads_to_seq")
    return x


class _LocalFlashCore(torch.autograd.Function):
    """Full local attention over (bh, s, d) rows in flash form (twin of the
    JAX ``_local_flash_core``): it saves only ``(qf, kf, vf, out, lse)``
    for the backward, which runs the block-gradient kernels, so no O(s^2)
    logits persist. Returns ``(out, lse)``; ``lse`` takes no gradient."""

    @staticmethod
    def forward(ctx, qf, kf, vf, causal: bool):
        bh, s, d = qf.shape
        m = torch.full((bh, s, 1), NEG_INF, dtype=torch.float32,
                       device=qf.device)
        l = torch.zeros((bh, s, 1), dtype=torch.float32, device=qf.device)
        acc = torch.zeros((bh, s, d), dtype=torch.float32, device=qf.device)
        m, l, acc = flash.block_attend(qf, kf, vf, 0, 0, causal, m, l, acc)
        l_safe = torch.clamp_min(l, 1e-30)
        out = acc / l_safe
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        qf, kf, vf, out, lse = ctx.saved_tensors
        dout = dout.float().contiguous()
        D = (dout * out).sum(-1, keepdim=True)
        dq, dk, dv = flash.flash_block_grads(qf, kf, vf, lse, dout, D, 0, 0,
                                             ctx.causal)
        return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), None


def _local_flash(q, k, v, causal: bool):
    """Exact local attention in flash form: (b, s, h, d) in and out, q
    scaled by 1/sqrt(d); the logits are never materialized at O(s^2)."""
    b, s, h, d = q.shape
    scale = 1.0 / (d ** 0.5)

    def rows(x):  # (b, s, h, d) -> contiguous (b*h, s, d), as the kernels take
        return x.transpose(1, 2).contiguous().view(b * h, s, d)

    qf, kf, vf = rows(q * scale), rows(k), rows(v)
    out, _lse = _LocalFlashCore.apply(qf, kf, vf, bool(causal))
    return out.reshape(b, h, s, d).transpose(1, 2).to(v.dtype)


def ulysses_attention(q, k, v, group=None, causal: bool = True):
    """Ulysses sequence parallelism: reshard to head-parallel, run exact
    full-sequence attention on the local heads through the flash kernels,
    reshard back. ``group`` is the sequence group (None: this rank
    alone)."""
    q = seq_to_heads(q, group)
    k = seq_to_heads(k, group)
    v = seq_to_heads(v, group)
    return heads_to_seq(_local_flash(q, k, v, causal), group)
