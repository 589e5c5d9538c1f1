"""The data-parallel mesh and its collectives (twin of
unet_research_tpu/parallel/mesh.py).

JAX gets a global-batch step from `jit` + `NamedSharding`: XLA partitions
the loss, the DropBlock hash's iota and the batch statistics, and inserts
the gradient psum. Here ranks of a `torch.distributed` process group each
hold a contiguous block of the global batch's rows, and the callers make
each global quantity global by hand with the collectives below: the loss
normaliser and the whole-batch DropBlock keep counts (`psum`), BatchNorm's
batch sums (`psum`, differentiable), the gradients (`all_reduce_grads_`,
one flat buffer), the MC ensemble's member outputs (`all_gather`), the seed
and the initial weights (`broadcast_`).

Every collective is an all-reduce or a broadcast of a tensor on the mesh's
device, so it runs on NCCL (one rank per card) and on gloo (CPU tensors,
or CUDA tensors through the host: the way two ranks share one card, which
NCCL refuses). NCCL's collectives are kernels on the card, which a CUDA
graph can hold; gloo's run on the host, which a graph cannot
(ops/cuda/launches.py::captures_on_card). Each call of a collective adds one to its count
in `calls`; ops/cuda/launches.py reads and credits these with the kernels'
launch counts, so a captured program's graph says how many collectives
one replay runs. `agree` holds the ranks to one graph before a capture.
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from unet_research_tpu_torch.device import resolve_device

# Calls so far of each collective, by kind (the two passes of a psum count
# once each).
calls = dict.fromkeys(("psum", "all_gather", "broadcast", "all_reduce_grads", "barrier"), 0)


class Mesh:
    """A ('data', 'model') mesh over the ranks of the default process group.
    The 'model' axis is reserved, as in JAX, and has size 1. `device` is
    this rank's device: every collective's tensors live there. `backend`:
    the process group's ('nccl' or 'gloo'; None for a mesh built by hand,
    which runs no collective)."""

    axis_names = ("data", "model")

    def __init__(self, group, data: int, model: int, rank: int, device: torch.device,
                 backend: Optional[str] = None):
        self.group = group
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.device = device
        self.backend = backend

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]


def multihost_initialize(init_method: str, world_size: int, rank: int,
                         backend: Optional[str] = None) -> None:
    """Join the default process group (thin wrapper over
    torch.distributed.init_process_group). backend: 'nccl' for ranks on
    cards, 'gloo' on the CPU when None; an explicit 'gloo' is honoured on
    cards (two ranks sharing one card). A failed init raises."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def make_mesh(data: Optional[int] = None, model: int = 1, device=None) -> Mesh:
    """A ('data', 'model') mesh spanning the initialised process group; data
    defaults to every rank. device: this rank's device (the current card
    unless the caller passes another)."""
    if model != 1:
        raise NotImplementedError("the 'model' axis is reserved: nothing shards on it")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost_initialize first")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    n = data * model
    if n > world:
        raise ValueError(f"need {n} ranks, the process group has {world}")
    if n < world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}: the mesh spans the group")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.group.WORLD, data, model, dist.get_rank(), dev, dist.get_backend())



def shard_rows(n: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's contiguous rows [r*n/R, (r+1)*n/R) of n global rows."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over {mesh.size} ranks")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


class Sharding(NamedTuple):
    """How a global array is laid over a mesh's ranks (twin of JAX's
    NamedSharding): `split` gives each rank its block of rows on the
    leading axis (P('data')), else every rank the whole array (P())."""

    mesh: Mesh
    split: bool


def data_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch or ensemble) axis split over 'data'."""
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def place(x, sharding: Sharding):
    """This rank's part of a global array or tensor x under `sharding`
    (JAX device_put with it)."""
    if not sharding.split:
        return x
    lo, hi = shard_rows(len(x), sharding.mesh)
    return x[lo:hi]


def shard_ensemble_keys(mesh: Mesh, keys):
    """This rank's members of an ensemble-input fan (site keys, angles):
    its block of rows, as JAX places the fan so that members split over
    'data'."""
    return place(keys, data_sharding(mesh))


def rank_offset(mesh: Optional[Mesh], n: int) -> int:
    """The global index of this rank's first row when each rank holds n rows
    (0 without a mesh): where its DropBlock counters start."""
    return 0 if mesh is None else mesh.rank * n


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=mesh.group)
    calls["psum"] += 1
    return y


class _PSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents over the ranks
    too (the loss is the sum of the ranks' losses)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over the mesh's ranks, differentiable (JAX lax.psum)."""
    return _PSum.apply(x, mesh)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x concatenated on dim 0 in rank order: an all-reduce of
    a zero-filled (R, ...) buffer in which each rank writes its slot
    (exact: the other slots add zeros)."""
    buf = torch.zeros((mesh.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    buf[mesh.rank] = x
    dist.all_reduce(buf, group=mesh.group)
    calls["all_gather"] += 1
    return buf.reshape((mesh.size * x.shape[0],) + tuple(x.shape[1:]))


@torch.no_grad()
def broadcast_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's x into x on every rank, in place."""
    dist.broadcast(x, src=0, group=mesh.group)
    calls["broadcast"] += 1
    return x


def broadcast_int(value: int, mesh: Mesh) -> int:
    """Rank 0's integer on every rank."""
    return int(broadcast_(torch.tensor([value], dtype=torch.int64, device=mesh.device), mesh))


@torch.no_grad()
def all_reduce_grads_(grads: list, mesh: Mesh) -> None:
    """Sum each gradient over the ranks, in place, with one all-reduce of
    one flat float32 buffer."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    calls["all_reduce_grads"] += 1
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all-reduce of one element on the mesh's
    device, which both backends take)."""
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
    calls["barrier"] += 1


def agree(key, mesh: Mesh) -> None:
    """Raise on every rank unless every rank passes an equal `key` (a
    graph's key, before its capture): a rank that captured other work than
    the others would wait in its collectives for ever. The key's repr is
    hashed (CRC-32) and the words gathered, so every rank sees every word
    and all raise together."""
    word = torch.tensor([zlib.crc32(repr(key).encode())], dtype=torch.int64,
                        device=mesh.device)
    words = all_gather(word, mesh)
    if not bool((words == words[0]).all()):
        raise RuntimeError(f"the ranks would capture different graphs: rank {mesh.rank} holds "
                           f"{key!r}, the ranks' key hashes are {words.tolist()}")
