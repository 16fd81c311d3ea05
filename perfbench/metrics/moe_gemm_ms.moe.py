"""Device milliseconds a traced step spends in the dropless expert layer's
grouped GEMMs: every device launch of ``torch._grouped_mm`` (the held
experts' gate and up, and down, products, forward, recomputed and
backward), found by a name holding one of ``MARKS`` (torch's grouped GEMM
kernels; the dense GEMMs hold none), in rank 0's traced block, summed,
over the block's ``perfbench.step`` spans.
None where the trace holds no such launch: an untraced run, or a program
without the layer."""

MARKS = ("groupproblemshape", "grouped_gemm", "grouped_mm")


def read(art):
    t = art.lead.get("trace")
    if not t:
        return None
    runs = [e - s for name, s, e in t["device"]
            if any(m in name.lower() for m in MARKS)]
    steps = sum(1 for name, _, _ in t["host"] if name == "perfbench.step")
    if not runs or not steps:
        return None
    return sum(runs) / 1e3 / steps
