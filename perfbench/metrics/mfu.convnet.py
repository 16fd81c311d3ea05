"""The whole step's model operations over its time and the card's peak,
in percent, over the traced run's steps outside the profiled block."""
from perfbench import readers


def read(art):
    return readers.mfu(art)
