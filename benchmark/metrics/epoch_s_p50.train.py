"""The median seconds of one epoch in the window."""

from benchmark import readers


def read(run):
    return readers.median_unit(run, "epoch")
