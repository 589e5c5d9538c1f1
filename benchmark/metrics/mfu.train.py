"""Model FLOP of the window's train steps (three forwards an image) over its
wall seconds and the cards' bf16 peak."""

from benchmark import readers


def read(run):
    return readers.mfu(run, "epoch", 3)
