"""Host -> device batch feeding (twin of unet_research_tpu/data/loading.py).

The reference leans on DataLoader worker processes
(base_model_tests/training.py:166-169). The split already sits in host
memory as uint8, so a batch is a numpy slice normalised to float32, copied
from pinned memory with `non_blocking=True`, `prefetch` batches ahead of
the one the caller is using: the copies overlap the previous steps' device
work. Under a mesh each rank takes, and uploads, only its rows of every
global batch (`shard_batch`, data-parallel feeding).
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from unet_research_tpu_torch.data.dataset import ArrayDataset
from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.parallel.mesh import Mesh, data_sharding, place, shard_rows


def to_device(arrays, device: torch.device) -> tuple:
    """numpy arrays -> tensors on `device`; through pinned memory and
    asynchronous copies on the card."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return tuple(out)


def batch_iterator(ds: ArrayDataset, batch_size: int, shuffle: bool,
                   rng: Optional[np.random.Generator] = None, drop_last: bool = False,
                   device=None, prefetch: int = 1, mesh=None) -> Iterator[tuple]:
    """Yield (image, target, mask) float32 NHWC batches on `device` (the
    card unless the caller asks for the CPU).

    shuffle=True reshuffles per call (per epoch) with `rng`, as the JAX
    package does, so one seed gives one order in both; shuffle=False keeps
    the order so batch_idx can index the MF size plans. drop_last drops a
    final partial batch. prefetch: how many batches beyond the one yielded
    are already copied to the device. mesh: yield this rank's rows of each
    batch (every rank shuffles alike from an equally seeded rng); a batch
    size the ranks do not divide raises ValueError before the first batch."""
    device = resolve_device(device)
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        if rng is None:
            rng = np.random.default_rng()
        rng.shuffle(order)
    stop = n - n % batch_size if drop_last else n
    if mesh is not None:
        for size in {min(batch_size, stop - s) for s in range(0, stop, batch_size)}:
            shard_rows(size, mesh)
    starts = iter(range(0, stop, batch_size))
    pending: deque = deque()

    def make_next() -> None:
        s = next(starts, None)
        if s is not None:
            idx = order[s:s + batch_size]
            if mesh is not None:
                idx = shard_batch(idx, mesh)
            pending.append(to_device(ds[idx], device))

    for _ in range(prefetch + 1):
        make_next()
    while pending:
        out = pending.popleft()
        make_next()
        yield out


def shard_batch(batch, sharding):
    """This rank's part of a global batch: an array or tensor, or a tuple of
    them, under `sharding` (parallel/mesh.py's data_sharding or replicated;
    a Mesh stands for its data_sharding). Twin of JAX shard_batch, which
    places a host batch with a NamedSharding."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(a, sharding) for a in batch)
    if isinstance(sharding, Mesh):
        sharding = data_sharding(sharding)
    return place(batch, sharding)
