"""Model FLOP of the window's member forwards over its wall seconds, as a share
of the card's bf16 peak."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "image", 1)
