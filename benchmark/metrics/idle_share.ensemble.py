"""The share of the profiled window in which the card ran no operation."""

from benchmark import readers


def read(run):
    return readers.idle_share(run, "image")
