"""The trace reader: device intervals from a ``torch.profiler`` Chrome
trace, their union over all streams, and the idle gaps between them.

Replaces the arithmetic of ``chip_smoke._profile_step`` (commit 3ba40e6),
which summed each kernel's own device time: NCCL on a side stream that
overlaps compute was then counted twice. Here busy time is the measure of
the union of the intervals, whatever stream they ran on. The Chrome trace
layout read here (``traceEvents``, complete events ``ph == "X"`` with
``ts``/``dur`` in microseconds, device work under the categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``) is the one that
``horovod_tpu_torch/testing.py:backward_overlap`` reads at that commit.
"""

from __future__ import annotations

import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")


def load(path: str) -> dict:
    """``{"device": [(name, start_us, end_us)], "host": [(name, start_us,
    end_us)]}`` from a Chrome trace file: every device operation, and the
    host's operators and annotations."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (e.get("name", ""), float(e["ts"]),
                float(e["ts"]) + float(e["dur"]))
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            device.append(span)
        elif cat in HOST_CATEGORIES:
            host.append(span)
    return {"device": device, "host": host}


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def measure(intervals) -> float:
    """The length of the union of ``intervals``."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, start: float, end: float) -> list:
    """The idle intervals of ``[start, end]`` that ``intervals`` leave."""
    out, t = [], start
    for s, e in union(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def innermost(host, times) -> list:
    """For each time in ``times``, the name of the shortest host span that
    holds it, or ``"host idle"`` where none does. One sweep over the spans
    sorted by start, with a heap of the open ones by length."""
    import heapq
    order = sorted(range(len(times)), key=lambda i: times[i])
    spans = sorted(host, key=lambda h: h[1])
    out = ["host idle"] * len(times)
    heap: list = []  # (length, end, name) of spans started so far
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][1] <= t:
            name, s, e = spans[j]
            heapq.heappush(heap, (e - s, e, name))
            j += 1
        # a span that ended before t holds no later time either
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        if heap:
            out[i] = heap[0][2]
    return out
