"""Weights from a seed, made on the device in a few large draws.

A model's weights are given by a spec: an ordered list of ``(name, shape,
init)`` with ``init`` one of ``("normal", std)``, ``("ones",)`` and
``("zeros",)``. Every normal leaf takes its values, in spec order, from
one stream of standard normals that a ``torch.Generator`` on the device
draws ``CHUNK`` at a time, scaled by the leaf's std. The same seed on the
same device gives the same weights, so the program's model and the plain
reference start from one set of weights that neither made.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 26  # normals per draw


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def pieces(spec, seed: int, device):
    """Yield ``(name, start, values)``: ``values`` (float32, flat) are the
    leaf's elements ``start:start + len(values)``."""
    g = _generator(seed, device)
    buf, used = None, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init[0] != "normal":
            fill = 1.0 if init[0] == "ones" else 0.0
            yield name, 0, torch.full((n,), fill, device=device)
            continue
        start = 0
        while start < n:
            if buf is None or used == buf.numel():
                buf = torch.randn(CHUNK, generator=g, device=device)
                used = 0
            take = min(n - start, buf.numel() - used)
            yield name, start, buf[used:used + take] * init[1]
            used += take
            start += take


@torch.no_grad()
def fill(params: dict, spec, seed: int) -> None:
    """Write the spec's weights from ``seed`` into ``params`` (name ->
    tensor of the spec's shape, on one device)."""
    device = next(iter(params.values())).device
    staged: dict = {}  # leaves not in row-major order (channels-last)
    for name, start, values in pieces(spec, seed, device):
        p = params[name]
        if p.is_contiguous():
            flat = p.view(-1)
        else:
            flat = staged.setdefault(name, torch.empty(p.numel(),
                                                       device=device))
        flat[start:start + values.numel()].copy_(values)
    for name, flat in staged.items():
        params[name].copy_(flat.view(params[name].shape))


@torch.no_grad()
def change_norms(params: dict, spec, seed: int) -> dict:
    """``{name: ||params[name] - initial||}``, float, with the initial
    weights drawn again from ``seed`` piece by piece (no second copy of
    the model is held)."""
    device = next(iter(params.values())).device
    sq = {name: torch.zeros((), dtype=torch.float64, device=device)
          for name, _, _ in spec}
    for name, start, values in pieces(spec, seed, device):
        flat = params[name].detach().contiguous().view(-1)
        d = flat[start:start + values.numel()].float() - values
        sq[name] += d.double().square().sum()
    norms = torch.stack(list(sq.values())).sqrt().tolist()
    return dict(zip(sq, norms))
