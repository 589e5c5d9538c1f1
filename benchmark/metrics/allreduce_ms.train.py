"""NCCL kernels' device time per step on rank 0 in the profiled window."""

from benchmark import readers


def read(run):
    return readers.nccl_ms_per_step(run)
