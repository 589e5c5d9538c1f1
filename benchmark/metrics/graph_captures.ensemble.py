"""CUDA graphs captured in the profiled window (the program's count): 0 unless
a program is built again."""

from benchmark import spans


def read(run):
    return spans.counted(run, "image", "graph:captures")
