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
"""

from __future__ import annotations

import math
from typing import Callable

import torch

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
