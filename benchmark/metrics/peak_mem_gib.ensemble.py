"""The peak device memory allocated over the window, on the fullest card."""

from benchmark import readers


def read(run):
    return readers.peak_gib(run, "image")
