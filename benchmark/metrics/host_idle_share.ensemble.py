"""The share of the profiled window in which the card idled because the host
had not yet handed it work (benchmark/spans.py), in %."""

from benchmark import spans


def read(run):
    return spans.host_idle_share(run, "image")
