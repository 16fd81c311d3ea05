"""Tokens trained by all cards over the window, per second."""
from perfbench import readers


def read(art):
    return readers.rate(art)
