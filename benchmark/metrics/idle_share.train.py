"""The share of the profiled window in which the cards ran no operation,
averaged over the ranks."""

from benchmark import readers


def read(run):
    return readers.idle_share(run, "epoch")
