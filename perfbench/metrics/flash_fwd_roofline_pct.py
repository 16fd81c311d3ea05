"""K1 (``flash_fwd``): the bound time of its launches over their device
time in the traced block, in percent."""
from perfbench import readers


def read(art):
    return readers.roofline_pct(art, ("flash_fwd",))
