"""The reference's first training steps, shared by the families.

A family's reference module gives ``param_spec(cfg)``, ``micro_batches(
rank_batch)`` (pieces whose mean losses, weighted by their share of the
rank's batch, give the rank's mean loss), and ``loss(params, piece, cfg,
precision)``. This module starts from the spec's weights drawn from the
seed, takes ``len(steps)`` steps, each on the batches of every rank
(the world's mean gradient, as the data-parallel sync averages it), with
the optimizer written out by hand, and returns what the comparison reads:
each step's loss, each leaf's gradient norm at the first step, and each
leaf's change over all the steps.
"""

from __future__ import annotations

import math

import torch

from ..frozen import weights
from . import lowp


def _adam(params, grads, state, t, hp) -> None:
    b1, b2 = hp["betas"]
    lr, eps = hp["lr"], hp["eps"]
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p),
                                       torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def _sgd(params, grads, state, t, hp) -> None:
    mu, lr = hp["momentum"], hp["lr"]
    for name, p in params.items():
        g = grads[name]
        if name not in state:
            state[name] = g.clone()
        else:
            state[name].mul_(mu).add_(g)
        p.add_(state[name], alpha=-lr)


UPDATES = {"adam": _adam, "sgd": _sgd}


def readings(family, cfg: dict, seed: int, steps, device,
             precision: str = lowp.FP32) -> dict:
    """Float32 with TF32 off (``lowp.fp32_exact``), or the control's fp8
    products. ``steps``: for each step, the list of every rank's batch. Returns
    ``{"losses": [...], "grad_norms": {leaf: norm}, "change_norms":
    {leaf: norm}}``."""
    with lowp.fp32_exact():
        return _readings(family, cfg, seed, steps, device, precision)


def _readings(family, cfg, seed, steps, device, precision) -> dict:
    spec = family.param_spec(cfg)
    params = {name: torch.empty(shape, device=device)
              for name, shape, _ in spec}
    weights.fill(params, spec, seed)
    hp = cfg["optimizer"]
    update = UPDATES[hp["kind"]]
    state: dict = {}
    out = {"losses": []}
    for t, rank_batches in enumerate(steps, start=1):
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        total = torch.zeros((), dtype=torch.float64, device=device)
        for rank_batch in rank_batches:
            for piece, share in family.micro_batches(rank_batch):
                leaves = {n: p.detach().requires_grad_()
                          for n, p in params.items()}
                w = share / len(rank_batches)
                loss = family.loss(leaves, piece, cfg, precision)
                (loss * w).backward()
                for n, p in leaves.items():
                    if p.grad is not None:
                        grads[n] += p.grad
                total += loss.detach().double() * w
                del leaves, loss
        out["losses"].append(total.item())
        if t == 1:
            norms = torch.stack([g.double().norm() for g in grads.values()])
            out["grad_norms"] = dict(zip(grads, norms.tolist()))
        with torch.no_grad():
            update(params, grads, state, t, hp)
        del grads
    out["change_norms"] = weights.change_norms(params, spec, seed)
    return out
