"""The largest ``torch.cuda.max_memory_allocated()`` of any rank over
the window, in GiB."""


def read(art):
    return max(r["peak_bytes"] for r in art.ranks) / 2 ** 30
