"""Expert parallelism: Mixture-of-Experts dispatch and combine over one
all-to-all each way (port of ``horovod_tpu/parallel/moe.py``).

One expert lives on each rank of an expert group (a ``torch.distributed``
group; None is this rank alone). Each rank routes its own tokens: top-k
routing, a capacity-bounded dispatch into one bucket per expert
(Switch/GShard style; tokens past a bucket's capacity drop and contribute
zero), one dim-0 all-to-all that hands every expert the buckets addressed
to it, the expert on what it received, the same all-to-all back, and the
gate-weighted combine. Dispatch and combine are torch index ops over the
flattened buckets (``index_add`` of the rows into their slots,
``index_select`` back), as they are XLA's in the JAX package; neither
makes the host wait for the card (``index_put``'s range check on CUDA
does, twice an index tensor). Everything differentiates, the router
through the gates::

    def expert_fn(tokens):           # (N, d) through this rank's expert
        return torch.relu(tokens @ w_in) @ w_out

    y, aux = moe_alltoall(x, router_logits, expert_fn, group)
    loss = task_loss(y) + 0.01 * aux  # Switch load-balance auxiliary

Beside it, the **dropless expert layer** of DeepSeek-V3-style models, which
the JAX package does not have: a rank holds ``n_held`` consecutive experts
of ``n_expert``, routes every token over all of them
(:func:`route_sigmoid_top_k`), and computes every (token, expert) pair
routed to the experts it holds, with no capacity: :func:`held_experts`.
The pairs are sorted by expert on the device, and the held experts' two
products are grouped GEMMs over the sorted rows (``torch._grouped_mm``) that
read the per-expert offsets where they lie; neither direction waits for the
device. Its buffers are sized for the most rows the held experts could get
(every pair), since their true count is known only on the device; rows past
the last offset are never read.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from .. import metrics, timeline
from .sequence import _all_to_all, _Exchange, group_size


def route_top_k(router_logits: torch.Tensor, k: int = 1):
    """Top-k routing: ``(expert_idx, gates)``, each (tokens, k). For k=1 the
    gate is the raw top softmax probability (Switch: renormalizing would
    make it 1 and cut the router off from the task loss); for k>1 the k
    gates are renormalized to a convex blend (GShard), floored at 1e-9."""
    probs = torch.softmax(router_logits, dim=-1)
    gates, expert_idx = torch.topk(probs, k, dim=-1)
    if k > 1:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return expert_idx, gates


def load_balance_loss(router_logits: torch.Tensor,
                      expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch Transformer's auxiliary loss (eq. 4): ``n_expert`` times the
    dot of the fraction of tokens whose primary expert is e and the mean
    router probability of e; 1 for a uniform assignment."""
    n_expert = router_logits.shape[-1]
    probs = torch.softmax(router_logits, dim=-1)
    onehot = _one_hot(expert_idx[..., 0], n_expert).to(probs.dtype)
    return n_expert * (onehot.mean(0) * probs.mean(0)).sum()


def _one_hot(idx, n: int):
    """``F.one_hot`` as a comparison (no check that syncs the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _tiled(buf, group):
    """Chunk j of dim 0 to rank j: its own inverse, so its gradient is the
    same movement."""
    return _all_to_all(buf.contiguous(), group)


def moe_alltoall(x: torch.Tensor, router_logits: torch.Tensor,
                 expert_fn: Callable, group=None, *, k: int = 1,
                 capacity: int | None = None,
                 capacity_factor: float = 1.25):
    """Route this rank's tokens through the group's experts and back.

    ``x`` (tokens, d) and ``router_logits`` (tokens, n_expert) are this
    rank's; ``n_expert`` is the size of ``group``, one expert a rank.
    ``expert_fn`` maps (N, d) -> (N, d_out) with THIS rank's expert.
    Returns ``(y, aux)``: ``y`` (tokens, d_out) the gate-weighted sum of
    each token's k expert outputs (dropped tokens contribute zero) and
    ``aux`` the load-balance loss.

    ``capacity`` bounds the tokens of each (source rank, expert) pair;
    default ``max(ceil(capacity_factor * k * tokens / n_expert), 4)``.
    Slots go in routing priority, pick-major: every token's first pick
    before any second pick, tokens in order within a pick.
    """
    tokens, d = x.shape
    n_expert = group_size(group)
    if tuple(router_logits.shape) != (tokens, n_expert):
        raise ValueError(
            f"router_logits shape {tuple(router_logits.shape)} != "
            f"({tokens}, axis size {n_expert})")
    if capacity is None:
        capacity = max(math.ceil(capacity_factor * k * tokens / n_expert), 4)

    expert_idx, gates = route_top_k(router_logits, k)
    flat_expert = expert_idx.t().reshape(-1)  # (k * tokens,) pick-major
    flat_token = torch.arange(tokens, device=x.device).repeat(k)
    flat_gate = gates.t().reshape(-1)
    onehot = _one_hot(flat_expert, n_expert)
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    keep = pos < capacity
    slot = flat_expert * capacity + pos.clamp_max(capacity - 1)

    dispatch = x.new_zeros((n_expert * capacity, d)).index_add(
        0, slot, torch.where(keep[:, None], x.index_select(0, flat_token),
                             torch.zeros_like(x[:1]))
    ).view(n_expert, capacity, d)
    # row s of recv is the bucket rank s addressed to this rank's expert
    recv = dispatch if n_expert == 1 else _Exchange.apply(
        dispatch, group, _tiled, _tiled)
    out = expert_fn(recv.reshape(n_expert * capacity, d))
    d_out = out.shape[-1]
    out = out.reshape(n_expert, capacity, d_out)
    back = out if n_expert == 1 else _Exchange.apply(
        out, group, _tiled, _tiled)

    picked = back.reshape(-1, d_out).index_select(0, slot) * torch.where(
        keep, flat_gate, torch.zeros_like(flat_gate))[:, None]
    y = picked.reshape(k, tokens, d_out).sum(0)
    return y, load_balance_loss(router_logits, expert_idx)


# --------------------------------------------------------------------------
# the dropless expert layer
# --------------------------------------------------------------------------

MOE_LANE = "moe"  # its spans: hvd.ROUTE.moe, hvd.EXPERTS.moe, hvd.COMBINE.moe


def route_sigmoid_top_k(router_logits: torch.Tensor, bias: torch.Tensor,
                        k: int, scale: float = 1.0):
    """DeepSeek-V3's routing (``scoring_func`` sigmoid, ``topk_method``
    noaux_tc with one group, ``norm_topk_prob``): scores ``s =
    sigmoid(logits)`` in float32; the k experts of the largest ``s + bias``
    (``bias`` the correction that steers the choice, not the weights);
    their weights ``s / sum(s) * scale``. Returns ``(expert_idx, weights,
    scores)``, the first two (tokens, k), scores (tokens, n_expert)."""
    scores = torch.sigmoid(router_logits.float())
    _, expert_idx = torch.topk(scores + bias, k, dim=-1)
    w = scores.gather(-1, expert_idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * scale
    return expert_idx, w, scores


def sequence_balance_loss(scores: torch.Tensor, expert_idx: torch.Tensor,
                          seqs: int) -> torch.Tensor:
    """DeepSeek-V3's complementary sequence-wise balance loss (its report,
    eqs. 17-20), before the factor alpha: over each of the ``seqs``
    sequences of T tokens (the rows of ``scores``, sequence-major),
    ``sum_i f_i P_i`` with ``f_i = N / (k T) * #{t: i in top-k of t}`` and
    ``P_i`` the mean over t of ``s_i,t / sum_j s_j,t``; the mean over the
    sequences. 1 where every expert gets its share and its scores agree."""
    n, k = scores.shape[-1], expert_idx.shape[-1]
    s = scores.reshape(seqs, -1, n)
    picks = torch.zeros_like(s).scatter_add_(
        -1, expert_idx.reshape(seqs, -1, k),
        torch.ones(expert_idx.shape, device=s.device).reshape(seqs, -1, k))
    f = picks.mean(1) * (n / k)
    p = (s / s.sum(-1, keepdim=True)).mean(1)
    return (f * p).sum(-1).mean()


def _swiglu(h, width: int):
    return F.silu(h[:, :width]) * h[:, width:]


class _Held(torch.autograd.Function):
    """The held experts' part of the layer on the expert-sorted rows:
    ``y[t] = sum_j w[t, j] E_e(x[t])`` over token t's picks j of a held
    expert e, ``E_e(x) = W_down,e (silu(W_gate,e x) * W_up,e x)``. Saves no
    row buffer: the backward gathers the rows and runs both products again
    (a held expert's few thousand rows make them cheap beside the memory
    that the buffers, sized for every pair, would take)."""

    @staticmethod
    def forward(ctx, x, w, w_gate_up, w_down, order, inv, held, offs):
        ctx.save_for_backward(x, w, w_gate_up, w_down, order, inv, held,
                              offs)
        k = w.shape[1]
        with timeline.span(MOE_LANE, "EXPERTS"):
            _, _, out = _experts(x, w_gate_up, w_down, order // k, offs)
        with timeline.span(MOE_LANE, "COMBINE"):
            return _combine(out, inv, held, w).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, w_gate_up, w_down, order, inv, held, offs = ctx.saved_tensors
        tokens, k = w.shape
        f = w_down.shape[-1]
        with timeline.span(MOE_LANE, "EXPERTS"):
            xs, h, out = _experts(x, w_gate_up, w_down, order // k, offs)
        with timeline.span(MOE_LANE, "COMBINE"):
            # each sorted row's share of dy, and the weights' gradient
            dys = dy.to(out.dtype).index_select(0, order // k)
            dw = (dys * out).sum(-1, dtype=torch.float32)
            dw = torch.where(held, dw.index_select(0, inv),
                             0.0).view(tokens, k)
            w_row = torch.where(held, w.reshape(-1), 0.0).index_select(
                0, order)
            dout = dys * w_row[:, None].to(dys.dtype)
        with timeline.span(MOE_LANE, "EXPERTS"):
            mm = torch._grouped_mm
            da = mm(dout, w_down, offs=offs)
            a = _swiglu(h, f)
            d_down = mm(dout.t(), a, offs=offs)
            g, u = h[:, :f], h[:, f:]
            dh = torch.cat((torch.ops.aten.silu_backward(da * u, g),
                            da * F.silu(g)), 1)
            dxs = mm(dh, w_gate_up, offs=offs)
            d_gate_up = mm(dh.t(), xs, offs=offs)
        with timeline.span(MOE_LANE, "COMBINE"):
            dx = _combine(dxs, inv, held, torch.ones_like(w))
        return (dx.to(x.dtype), dw, d_gate_up, d_down, None, None, None,
                None)


def _experts(x, w_gate_up, w_down, token, offs):
    """Gather each sorted row's token and run the held experts on it:
    ``(rows, gate|up products, outputs)``."""
    xs = x.index_select(0, token)
    mm = torch._grouped_mm
    h = mm(xs, w_gate_up.transpose(-2, -1), offs=offs)
    out = mm(_swiglu(h, w_down.shape[-1]), w_down.transpose(-2, -1),
             offs=offs)
    return xs, h, out


def _combine(rows, inv, held, w):
    """``y[t] = sum_j w[t, j] rows[inv[t k + j]]`` over the picks j of a
    held expert, in float32 and in a fixed order (no atomics), one pick at a
    time; the other picks' rows, past the last offset, never enter the
    sum."""
    tokens, k = w.shape
    inv, held = inv.view(tokens, k), held.view(tokens, k)
    y = torch.zeros((tokens, rows.shape[-1]), device=rows.device)
    for j in range(k):
        picked = rows.index_select(0, inv[:, j])
        y += torch.where(held[:, j, None], picked, 0.0) * w[:, j, None]
    return y


def held_experts(x: torch.Tensor, expert_idx: torch.Tensor,
                 weights: torch.Tensor, w_gate_up: torch.Tensor,
                 w_down: torch.Tensor, first: int, *,
                 layer: str | None = None) -> torch.Tensor:
    """The dropless layer's part that the experts ``first .. first +
    n_held - 1`` give, on this rank's tokens.

    ``x`` (tokens, d) in the products' dtype (bf16 on the card: the grouped
    GEMMs take bf16); ``expert_idx`` and ``weights`` (tokens, k) from
    :func:`route_sigmoid_top_k`, over all experts; ``w_gate_up`` (n_held,
    2 f, d) the held experts' gate and up projections stacked, ``w_down``
    (n_held, d, f), both in ``x``'s dtype. Every pick of a held expert is
    computed; the other picks add nothing (another rank's experts give
    them). Returns (tokens, d) in ``x``'s dtype. With ``layer``, each held
    expert's rows are tallied on the device (``metrics.MOE_EXPERT_ROWS``).
    No host synchronisation: the sort, the offsets and the products stay on
    the device."""
    n_held = w_gate_up.shape[0]
    tokens, k = expert_idx.shape
    with timeline.span(MOE_LANE, "ROUTE"):
        local = expert_idx.reshape(-1) - first
        held = (local >= 0) & (local < n_held)
        key = torch.where(held, local, n_held)  # the other picks sort last
        order = torch.sort(key, stable=True).indices
        rows = torch.zeros(n_held + 1, dtype=torch.int64,
                           device=x.device).scatter_add_(
                               0, key, torch.ones_like(key))[:n_held]
        offs = rows.cumsum(0).to(torch.int32)
        # sorted row r holds pick order[r], of token order[r] // k; pick p
        # lies in sorted row inv[p]
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=x.device))
        if layer is not None:
            metrics.tally_expert_rows(layer, first, rows)
    return _Held.apply(x, weights, w_gate_up, w_down, order, inv, held,
                       offs)
