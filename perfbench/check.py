"""The comparison that decides ``correct``.

The program's first ``CHECK_STEPS`` training steps against the plain
reference's, from the same weights on the same batches. Numbers read:

* ``loss_gap``: the largest, over the steps, of the gap between the
  program's loss (the world's mean) and the reference's, relative to the
  reference's; ``first_loss_gap``: the same at the first step alone;
* ``grad_gap``: the largest, over the leaves, of the gap between the
  norm of the program's first gradient (as its optimizer got it, after
  the sync) and the reference's, relative to the larger of the
  reference's norm of that leaf and of the median leaf;
  ``grad_gap_median_leaf``: the median over the leaves of that gap, and
  ``grad_gap_q90`` its 90th percentile (linear interpolation);
* ``change_gap`` and ``change_gap_median_leaf``: the same for each
  leaf's change from the initial weights after the checked steps. Leaves
  whose reference gradient at the first step is under ``IGNORE_BELOW`` of
  the median leaf's are left out: the optimizer moves them by round-off
  alone.

A cell holds the numbers that its ``limits/<workload>.json`` names, each
to its limit; PERF.md gives the readings each limit was set from, and
why a cell holds the numbers it does.
"""

from __future__ import annotations

from .frozen import stats

IGNORE_BELOW = 1e-3
NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "grad_gap_median_leaf",
           "grad_gap_q90", "change_gap", "change_gap_median_leaf")


def _rel_gaps(prog: dict, ref: dict, leaves) -> dict:
    floor = stats.median([ref[n] for n in leaves])
    return {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
            for n in leaves}


def _worst(rel: dict, ref: dict) -> list:
    """The three leaves that read the most: name, gap, reference norm over
    the median leaf's."""
    med = stats.median(list(ref[n] for n in rel))
    return [[n, rel[n], ref[n] / med]
            for n in sorted(rel, key=lambda n: -rel[n])[:3]]


def gaps(program: dict, reference: dict) -> dict:
    rl, pl = reference["losses"], program["losses"]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(pl, rl))
    grads = reference["grad_norms"]
    leaves = sorted(grads)
    missing = set(leaves) ^ set(program["grad_norms"])
    if missing or len(pl) != len(rl):
        raise RuntimeError(f"program and reference disagree on leaves "
                           f"{sorted(missing)[:5]} or steps")
    g_rel = _rel_gaps(program["grad_norms"], grads, leaves)
    med = stats.median([grads[n] for n in leaves])
    counted = [n for n in leaves if grads[n] >= IGNORE_BELOW * med]
    c_rel = _rel_gaps(program["change_norms"], reference["change_norms"],
                      counted)
    return {"loss_gap": loss_gap, "grad_gap": max(g_rel.values()),
            "change_gap": max(c_rel.values()),
            "grad_gap_median_leaf": stats.median(list(g_rel.values())),
            "grad_gap_q90": stats.percentile(list(g_rel.values()), 90.0),
            "change_gap_median_leaf": stats.median(list(c_rel.values())),
            "first_loss_gap": abs(pl[0] - rl[0]) / abs(rl[0]),
            "leaves_left_out": len(leaves) - len(counted),
            "worst_grad": _worst(g_rel, grads),
            "worst_change": _worst(c_rel, reference["change_norms"])}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) over the numbers ``limits``
    names: correct where there is at least one and each is within its
    limit."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        checks[name] = {"value": found[name], "limit": limit}
        if not found[name] <= limit:
            ok = False
    return ok, checks
