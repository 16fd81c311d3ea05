"""K2 and K3 (``flash_bwd_dq``, ``flash_bwd_dkv``) together: their
launches' bound time over their device time in the traced block, in
percent."""
from perfbench import readers


def read(art):
    return readers.roofline_pct(art, ("flash_bwd_dq", "flash_bwd_dkv"))
