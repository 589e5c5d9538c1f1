"""The share of rank 0's profiled window in which its card idled because the
host had not yet handed it work (benchmark/spans.py), in %."""

from benchmark import spans


def read(run):
    return spans.host_idle_share(run, "epoch")
