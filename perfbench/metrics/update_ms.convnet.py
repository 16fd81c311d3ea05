"""Median, over the steps outside the profiled block, of the device time
from the event after backward() to the next step's start: the sync's
exposed part, the unpack and the optimizer."""
from perfbench import readers


def read(art):
    return readers.median_ms(art, "update_ms")
