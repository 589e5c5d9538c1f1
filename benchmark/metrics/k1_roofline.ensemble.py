"""K1's launches' bounds over their device time in the profiled window."""

from benchmark import readers


def read(run):
    return readers.roofline_share(run, "k1", "image")
