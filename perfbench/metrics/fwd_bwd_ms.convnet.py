"""Median, over the steps outside the profiled block, of the device time
from a step's start to the event after its backward() returned."""
from perfbench import readers


def read(art):
    return readers.median_ms(art, "fwd_bwd_ms")
