"""The arithmetic that the metric files share: from the ranks' results
(step marks, the traced block's device intervals) to a
number. A reader returns None where its run holds nothing to read."""

from __future__ import annotations

from .frozen import roofline, stats, trace


class Artefacts:
    """What a run left to read: ``ranks``, one result a rank, rank 0
    first (see ``worker.run_rank``)."""

    def __init__(self, cell: dict, config: dict, traffic: dict,
                 ranks: list):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.ranks = sorted(ranks, key=lambda r: r["rank"])
        self.lead = self.ranks[0]
        self.work = self.lead["work"]


def rate(art: Artefacts):
    """Items trained by all ranks over the window, per second."""
    r = art.lead
    return r["steps"] * art.work["items"] * r["world"] / r["window_s"]


def unprofiled(art: Artefacts, key: str) -> list:
    """Rank 0's per-step times under ``key`` outside the profiled block."""
    skip = set(art.lead["profiled"])
    return [v for i, v in enumerate(art.lead[key]) if i not in skip]


def median_ms(art: Artefacts, key: str):
    return stats.median(unprofiled(art, key))


def mfu(art: Artefacts):
    """Model operations of the steps outside the profiled block over
    their time and the card's bf16 peak, in percent (each rank does the
    same work in the same time)."""
    ms = unprofiled(art, "step_ms")
    peak = roofline.PEAK_FLOPS[art.work["dtype"]]
    return 100.0 * art.work["flops"] * len(ms) / (sum(ms) / 1e3) / peak


def _block(r: dict):
    """The traced block of rank ``r``: its device intervals and its span,
    from the first step annotation's start to the last device end."""
    t = r.get("trace")
    if not t or not t["device"]:
        return None
    dev = [(s, e) for _, s, e in t["device"]]
    steps = [s for name, s, _ in t["host"] if name == "perfbench.step"]
    start = min([min(s for s, _ in dev)] + steps)
    end = max(e for _, e in dev)
    return t, dev, start, end


def busy_window_s(art: Artefacts):
    """(busy, window) seconds of the traced block, averaged over ranks;
    None where no rank was traced."""
    got = [b for b in map(_block, art.ranks) if b is not None]
    if not got:
        return None
    busy = [trace.measure([(max(s, st), min(e, en)) for s, e in dev
                           if e > st and s < en]) for _, dev, st, en in got]
    window = [en - st for _, _, st, en in got]
    return sum(busy) / len(got) / 1e6, sum(window) / len(got) / 1e6


def idle_pct(art: Artefacts):
    bw = busy_window_s(art)
    if bw is None:
        return None
    return 100.0 * (1.0 - bw[0] / bw[1])


def roofline_pct(art: Artefacts, kernels: tuple):
    """The flash kernels' bound time over their device time, in percent:
    every launch of ``kernels`` in the traced block, each launch's bound
    from the step's shape (``work["flash"]``)."""
    work = art.work.get("flash") or {}
    t = art.lead.get("trace")
    if not t or not all(k in work for k in kernels):
        return None
    bound = 0.0
    device = 0.0
    for k in kernels:
        runs = [(s, e) for name, s, e in t["device"]
                if "hvdflash" in name and f"{k}_" in name]
        if not runs:
            return None
        bound += len(runs) * roofline.bound_ms(*work[k], art.work["dtype"])[0]
        device += sum(e - s for s, e in runs) / 1e3
    return 100.0 * bound / device


def breakdown(art: Artefacts) -> dict | None:
    """Rank 0's traced block: the device operations that took most time,
    and the idle gaps by the host operation that was running, each summed
    by name, in seconds, at most 10 of each."""
    b = _block(art.lead)
    if b is None:
        return None
    t, dev, start, end = b
    ops: dict = {}
    for name, s, e in t["device"]:
        ops[name[:160]] = ops.get(name[:160], 0.0) + (e - s) / 1e6
    idle: dict = {}
    gaps = trace.gaps(dev, start, end)
    names = trace.innermost(t["host"], [s for s, _ in gaps])
    for (s, e), name in zip(gaps, names):
        idle[name[:160]] = idle.get(name[:160], 0.0) + (e - s) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in longest]}
