"""The median milliseconds of the host's issue of one step (`trainer.step`
spans: a replay's launch and its credit) in rank 0's profiled window."""

import statistics

from benchmark import spans


def read(run):
    return spans.span_ms(run, "epoch", "trainer.step", statistics.median)
