"""The milliseconds of the step program's table fill (`trainer.fill` spans) in
rank 0's profiled window: the site keys and drop probabilities of every
step of the epoch drawn on the host, and the tables' copies."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "epoch", "trainer.fill")
