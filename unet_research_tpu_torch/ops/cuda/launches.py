"""The kernel wrappers' launch counts, read and credited as one, and the
capture of a CUDA graph that keeps them.

Each wrapper adds one to its `launches` where it launches its kernel (and
conv3x3_pair's launches are also counted by kernel in `path_launches`);
each collective of parallel/mesh.py adds one to its count in `calls`, and
each attention call on the card (ops/attention.py) one to `attn:flash` or
`attn:other`, each upsampling merge (ops/cuda/upsample.py) one to
`up:kernel` or `up:plain`, and each U-Net skip merge under the fused route
(models/unet.py::_Pass.up_merge) one to `merge:kernel` (a launch of K1's
merge mode, which also counts on `dropblock_fused_apply`) or `merge:plain`.
`KERNELS` names the kernel behind each launch
count, so that a profiler's records can be held against the counts. A
CUDA graph replays the kernels and collectives that its capture recorded
without calling a wrapper, so whoever replays one credits the counts that
the capture added (`since`), once per replay (`credit`), and takes them
back from the capture itself, which launched nothing (`capture`).
`KeyedGraphs` keeps one such graph per key, each after eager warm-up runs
of its own.

Five host-side counts ride in the same snapshot (`HOST`): `graph:captures`,
one per `capture`; `members:host` / `members:program`, the ensemble
members merged from the host and in an ensemble program
(uncertainty/ensemble.py); `gn:plain`, the GroupNorm sites on the card
that ran the plain ops instead of ops/cuda/group_norm.py's kernels, and
`bn:plain`, the BatchNorm sites on the card that ran the plain ops instead
of `gn_apply` (models/sites.py; every train-mode one). They count what the
host did, so a capture keeps them and no replay credits them; `launched`
leaves them out.

Whether a program captures at all is decided once, when it is built
(`captures_on_card`): on the card, unless the caller asked for the host's
route (program=False), and, when the captured work holds collectives of a
mesh, only under NCCL, whose collectives a graph can hold. Under gloo the
same program runs every step eagerly on the card. Nothing decides it
after a failed capture: a failed capture or replay raises.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Callable

import torch

from unet_research_tpu_torch.ops import attention
from unet_research_tpu_torch.ops.cuda import (
    dropblock_kernel,
    group_norm,
    pair_conv,
    shear_rotate,
    upsample,
)
from unet_research_tpu_torch.parallel import mesh as _mesh
from unet_research_tpu_torch.spans import span

WRAPPERS = (dropblock_kernel.dropblock_fused_apply, dropblock_kernel.dropblock_mask,
            pair_conv.conv3x3_pair, pair_conv.conv3x3_pair_dx, pair_conv.conv3x3_pair_fold,
            shear_rotate.rotate_fan, shear_rotate.rotate_fan_table, *group_norm.WRAPPERS,
            upsample.upsample_concat)

# the kernel behind each launch count of a snapshot, by a part of its name in
# the profiler's records: what a profiled window's kernels are held against
# (K1's `dropblock_apply_kernel` also names its merge mode's kernel,
# `dropblock_apply_kernel_merge`, counted on the same wrapper)
KERNELS = {"dropblock_mask_kernel": "dropblock_mask",
           "dropblock_apply_kernel": "dropblock_fused_apply",
           "conv3x3_wgmma_kernel": "path:wgmma", "conv3x3_kernel<": "path:cuda_cores",
           "conv3x3_fold_kernel": "conv3x3_pair_fold", "shear_fan_kernel": "rotate_fan",
           "shear_fan_table_kernel": "rotate_fan_table",
           **{f"{fn.__name__}_kernel": fn.__name__ for fn in group_norm.WRAPPERS},
           "upsample_concat_kernel": "upsample_concat"}


def captures_on_card(program: bool = True, mesh=None) -> bool:
    """Whether a program captures its graphs when it runs on the card:
    unless program is False (the host's route), and, where `mesh` is the
    mesh whose collectives the captured work holds (None: it holds none),
    only when a graph can hold them: NCCL's collectives are kernels on the
    card, gloo's run on the host. On the CPU nothing captures."""
    return bool(program) and (mesh is None or mesh.backend == "nccl")


# the host-side counts (module docstring), by their names in a snapshot
HOST = {"graph:captures": 0, "members:host": 0, "members:program": 0, "gn:plain": 0,
        "bn:plain": 0}

# credit's dispatch: the count tables by the prefix of a snapshot's name
_TABLES = {"path": pair_conv.path_launches, "collective": _mesh.calls, "attn": attention.calls,
           "up": upsample.calls, "merge": dropblock_kernel.merges}
_BY_NAME = {fn.__name__: fn for fn in WRAPPERS}


def snapshot() -> dict:
    """Every count now: {wrapper name: launches}, {"path:<kernel>": K3
    launches by kernel}, {"collective:<kind>": calls}, {"attn:<route>":
    attention calls}, {"up:<route>": upsampling merges}, {"merge:<route>":
    skip merges} and the host-side counts of HOST."""
    counts = {name: fn.launches for name, fn in _BY_NAME.items()}
    for prefix, table in _TABLES.items():
        counts.update({f"{prefix}:{k}": v for k, v in table.items()})
    counts.update(HOST)
    return counts


def since(before: dict) -> dict:
    """The counts added since `before` (a snapshot), the nonzero ones."""
    now = snapshot()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def launched(counts: dict) -> dict:
    """`counts` without the host-side ones: the kernel launches and
    collectives that a replay of a capture that added them runs."""
    return {k: v for k, v in counts.items() if k not in HOST}


def credit(counts: dict, times: int = 1) -> None:
    """Add `counts` (as `since` gives them) `times` times; a negative
    `times` takes them back."""
    for k, v in counts.items():
        prefix, _, name = k.partition(":")
        if k in HOST:
            HOST[k] += v * times
        elif name:
            _TABLES[prefix][name] += v * times
        else:
            _BY_NAME[k].launches += v * times


def capture(step: Callable[[], None]) -> tuple:
    """Record step() as a CUDA graph on the current device. Returns (the
    graph, the counts that one replay is to be credited with, the capture's
    seconds); the counts that the capture's wrapper calls added are taken
    back, also when the capture fails.

    Python's cyclic garbage collector runs before the capture and is held
    off during it. A program cached on an engine or a trainer keeps its
    graph in a reference cycle, so a dropped one is freed by that collector;
    freeing a graph destroys its executable graph, a call that a capture
    forbids, and the capture then fails where it ends."""
    gc.collect()
    before = snapshot()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with span("graph.capture"):
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph):
                step()
            seconds = time.perf_counter() - t0
    finally:
        if enabled:
            gc.enable()
        counts = launched(since(before))
        credit(counts, -1)
        HOST["graph:captures"] += 1
    return graph, counts, seconds


class KeyedGraphs:
    """One CUDA graph per key (an input shape, a step's size and rows),
    each recorded after WARMUP eager runs of its own, as PyTorch's CUDA
    graph notes ask: the first run of a shape does the one-time work that
    a capture cannot hold (the kernel libraries' loading, K3's
    shared-memory limit, cuDNN's plans, NCCL's communicator). Subclasses
    set WARMUP.

    captures: False runs every call eagerly (captures_on_card decided it
    when the program was built). mesh: the mesh whose collectives fn
    holds, or None. Its ranks run the same keys in the same order, so
    each rank warms up, captures and replays in step with the others; the
    ranks agree on a key before its capture (parallel/mesh.py::agree) and
    all raise when they do not."""

    WARMUP = 1

    def __init__(self, captures: bool = True, mesh=None):
        self.captures, self.mesh = captures, mesh
        self.warm = collections.Counter()  # eager runs so far, by key
        # by key: the graph, the kernel launches and collectives of one
        # replay and the capture's seconds
        self.graphs, self.replay_counts, self.capture_seconds = {}, {}, {}

    def run(self, key, fn: Callable[[], None], device: torch.device) -> bool:
        """fn() for `key` on the card: eagerly on a side stream while the
        key has had fewer than WARMUP eager runs, else a replay of its
        graph, which is recorded from fn first (`capture`; fn does not run
        then), crediting the capture's counts; without `captures`, fn()
        eagerly. Returns whether the graph replayed. A failed capture or
        replay raises."""
        if not self.captures:
            fn()
            return False
        graph = self.graphs.get(key)
        if graph is None and self.warm[key] < self.WARMUP:
            self.warm[key] += 1
            with span("graph.warmup"):
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    fn()
                torch.cuda.current_stream(device).wait_stream(side)
            return False
        if graph is None:
            if self.mesh is not None:
                _mesh.agree(key, self.mesh)
            graph, self.replay_counts[key], self.capture_seconds[key] = capture(fn)
            self.graphs[key] = graph
        graph.replay()
        credit(self.replay_counts[key])
        return True
