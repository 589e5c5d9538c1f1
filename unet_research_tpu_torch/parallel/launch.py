"""Spawn local ranks of one data-parallel run (the way PL's `--gpus N`
spawns its DDP workers).

`spawn(fn, args, devices)` starts one process per entry of `devices`
(spawned, not forked: the caller may already hold a CUDA context), each of
which joins a process group that meets on a free 127.0.0.1 TCP port, makes
its device current and calls fn(*args). A rank that raises fails the whole
call (torch.multiprocessing ends the others); rank 0's return value comes
back to the caller.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from unet_research_tpu_torch.parallel.mesh import multihost_initialize


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, args: tuple, devices: list, backend: Optional[str],
               init_method: str, result_path: str) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    multihost_initialize(init_method, len(devices), rank, backend=backend)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(result_path, "wb") as f:
            pickle.dump(out, f)


def spawn(fn: Callable, args: tuple, devices: Sequence[str], backend: Optional[str] = None):
    """fn(*args) in len(devices) ranks, rank r on devices[r] ('cuda:r',
    'cpu', or one card named twice for ranks that share it). backend: nccl
    for ranks on cards and gloo on the CPU when None (ranks that share a
    card need 'gloo'). fn must be importable (it is pickled by name) and
    return something picklable. Returns rank 0's result."""
    init_method = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(_rank_main, args=(fn, tuple(args), list(devices), backend,
                                             init_method, result_path),
                           nprocs=len(devices), join=True, start_method="spawn")
        with open(result_path, "rb") as f:
            return pickle.load(f)
