"""Share of the traced block's time in which no kernel, copy or set
runs on the card, from the union of its intervals over all streams."""
from perfbench import readers


def read(art):
    return readers.idle_pct(art)
