"""CUDA graphs captured in the profiled window (the program's count, rank 0):
0 unless a step program is built again."""

from benchmark import spans


def read(run):
    return spans.counted(run, "epoch", "graph:captures")
