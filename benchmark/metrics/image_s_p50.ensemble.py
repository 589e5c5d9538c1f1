"""The median seconds of one image's predict and read-back in the window."""

from benchmark import readers


def read(run):
    return readers.median_unit(run, "image")
