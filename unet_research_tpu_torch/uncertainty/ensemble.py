"""Streaming ensemble statistics (twin of unet_research_tpu/uncertainty/ensemble.py).

Members are evaluated in chunks and merged into a running (count, mean, M2)
with Chan's parallel-variance combine, so memory holds one chunk of
activations whatever the ensemble size. The statistics match torch's
mean(0) / std(0) (unbiased) of the stacked members to float32 accuracy.
The count is a float32 tensor on the members' device, as JAX's is.

Chunk order, as in JAX: the first `return_num` members in one batch (kept
as `saved`, the reference's tensors[0:return_num]), then full chunks of
`chunk`, then the remainder. JAX runs the full chunks after the first one
(the first two when no member is saved) as one `lax.scan` body
(ensemble.py:90-94, :150-154); here `EnsembleProgram` is that body: one
chunk step on static device buffers, captured once as a CUDA graph on the
card and replayed once per body chunk. The other chunks run from the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.parallel.mesh import agree


def _batch_stats(outs: torch.Tensor):
    mean = outs.mean(dim=0)
    count = torch.full((), float(outs.shape[0]), dtype=torch.float32, device=outs.device)
    return count, mean, ((outs - mean) ** 2).sum(dim=0)


def _merge(stats, new_stats):
    count, mean, m2 = stats
    new_count, new_mean, new_m2 = new_stats
    tot = count + new_count
    delta = new_mean - mean
    mean = mean + delta * (new_count / tot)
    m2 = m2 + new_m2 + delta * delta * (count * new_count / tot)
    return tot, mean, m2


class Layout(NamedTuple):
    """The chunks of one ensemble in JAX's order: `sizes` of every chunk, of
    which sizes[body_start:body_start + n_body] (all of size `chunk`) are
    JAX's scanned body."""

    sizes: list
    body_start: int
    n_body: int


def chunk_layout(total: int, chunk: int, return_num: int = 0) -> Layout:
    if total < 2:
        raise ValueError("ensemble needs >= 2 members for std")
    return_num = min(return_num, total)
    head = [return_num] if return_num > 0 else []
    rest = total - return_num
    n_full = rest // chunk
    if n_full > 0 and not head:
        head.append(chunk)  # the first chunk starts the statistics, outside the scan
    n_body = n_full - (1 if return_num == 0 and n_full > 0 else 0)
    tail = [rest - n_full * chunk] if rest % chunk else []
    return Layout(head + [chunk] * n_body + tail, len(head), n_body)


def ensemble_stats(outputs: Callable[[int, int], torch.Tensor], layout: Layout,
                   return_num: int, program: "EnsembleProgram | None" = None):
    """(mean, std, saved) over the chunks of `layout`, where outputs(c, size)
    returns chunk c's members' outputs stacked on dim 0. With a program,
    the body chunks run in it (its buffers filled by the caller) and
    `outputs` is called for the others only. Statistics reduce in float32;
    std is unbiased."""
    stats = saved = None
    c = 0
    while c < len(layout.sizes):
        if program is not None and c == layout.body_start and layout.n_body:
            stats = program.run(stats, layout.n_body)
            c += layout.n_body
            continue
        outs = outputs(c, layout.sizes[c]).to(torch.float32)
        bstats = _batch_stats(outs)
        stats = bstats if stats is None else _merge(stats, bstats)
        if c == 0 and return_num > 0:
            saved = outs
        c += 1
    count, mean, m2 = stats
    std = torch.sqrt(m2 / (count - 1.0))
    if saved is None:
        saved = torch.zeros((0,) + tuple(mean.shape), dtype=torch.float32, device=mean.device)
    return mean, std, saved


def streaming_ensemble(sample_fn: Callable, xs: torch.Tensor, chunk: int, return_num: int = 0,
                       chunk_fn: bool = False):
    """(mean, std, saved) over the members xs[i] in chunks of `chunk`.

    sample_fn maps one member's input xs[i] to its output, and each chunk's
    outputs are stacked (JAX vmaps sample_fn; the same function); with
    chunk_fn=True it maps a slice of xs to its members' outputs stacked on
    dim 0 (a real device batch, as the engines run). `saved` holds the
    first return_num outputs."""
    layout = chunk_layout(xs.shape[0], chunk, return_num)
    starts = [sum(layout.sizes[:c]) for c in range(len(layout.sizes))]

    def outputs(c: int, size: int):
        part = xs[starts[c]:starts[c] + size]
        if chunk_fn:
            return sample_fn(part)
        return torch.stack([sample_fn(x) for x in part])

    return ensemble_stats(outputs, layout, min(return_num, xs.shape[0]))


def streaming_ensemble_batched(batch_fn: Callable, generator: torch.Generator, total: int,
                               chunk: int, return_num: int = 0):
    """streaming_ensemble over `total` members, where batch_fn(generator,
    size) returns `size` fresh members stacked on dim 0, drawing what it
    needs from the generator (JAX's batch_fn(key, size) on the chunk's
    fold_in(key, index); the generator takes the key's place, and chunk
    after chunk draws from it in the same order)."""
    return ensemble_stats(lambda c, size: batch_fn(generator, size),
                          chunk_layout(total, chunk, return_num), min(return_num, total))


class EnsembleProgram:
    """The body chunks of one ensemble layout as one device program (the
    twin of JAX's lax.scan over them).

    It holds static device buffers: the running (count, mean, M2), the
    input image and FOV mask, per-chunk input tables and the chunk index
    `index` on the device. `members(program)` computes the member outputs
    of the body chunk at `program.index` from those buffers alone; a step
    merges them into the running statistics and advances the index. On the
    card the step is captured once as a CUDA graph and replayed once per
    body chunk, and `run` synchronises nowhere (the caller reads the
    statistics once per ensemble); on the CPU the same step runs eagerly.
    A failed capture raises: nothing falls back to the chunks from the
    host.

    The caller fills `image`, `mask` and `tables` before `run`; a graph
    reads them at their addresses, so they are written in place and never
    replaced."""

    # Eager steps before the capture, on a side stream, as PyTorch's CUDA
    # graph notes ask: real body chunks of the program's first run(s). The
    # first loads the kernel libraries, raises the kernels' shared-memory
    # limits and builds cuDNN's plans at the chunk's shapes, the one-time
    # work that a capture cannot hold. Inference has no other lazy state.
    WARMUP = 1

    def __init__(self, members: Callable[["EnsembleProgram"], torch.Tensor], image_shape,
                 tables: dict, device: torch.device, captures: bool = True, mesh=None):
        self.members = members
        self.captures, self.mesh = captures, mesh
        self.image = torch.zeros(image_shape, dtype=torch.float32, device=device)
        self.mask = torch.zeros(image_shape, dtype=torch.float32, device=device)
        self.tables = tables
        self.index = torch.zeros(1, dtype=torch.int64, device=device)
        self.count = torch.zeros((), dtype=torch.float32, device=device)
        self.mean = self.m2 = None  # shaped by the first run's statistics
        self.graph = None
        self.warmed = 0
        self.replay_counts = {}  # kernel launches of one replay (ops/cuda/launches.py)
        self.capture_seconds = None

    def row(self, name: str) -> torch.Tensor:
        """Table `name`'s row at the chunk index."""
        return self.tables[name].index_select(0, self.index)[0]

    def step(self) -> None:
        """One body chunk at the chunk index, merged into the buffers."""
        outs = self.members(self).to(torch.float32)
        count, mean, m2 = _merge((self.count, self.mean, self.m2), _batch_stats(outs))
        self.count.copy_(count)
        self.mean.copy_(mean)
        self.m2.copy_(m2)
        self.index.add_(1)

    def capture(self) -> None:
        """Record one step as a CUDA graph (launches.capture), once the
        mesh's ranks agree on the program."""
        if self.mesh is not None:
            agree(("ensemble", tuple(self.image.shape), tuple(self.mean.shape),
                   {k: tuple(t.shape) for k, t in self.tables.items()}), self.mesh)
        self.graph, self.replay_counts, self.capture_seconds = launches.capture(self.step)

    def run(self, stats, n: int):
        """Merge the n body chunks into stats = (count, mean, M2). Returns the
        merged statistics (new tensors)."""
        count, mean, m2 = stats
        if self.mean is None:
            self.mean, self.m2 = torch.zeros_like(mean), torch.zeros_like(m2)
        self.count.copy_(count)
        self.mean.copy_(mean)
        self.m2.copy_(m2)
        self.index.zero_()
        dev = self.index.device
        if dev.type != "cuda" or not self.captures:
            for _ in range(n):
                self.step()
        else:
            done = 0
            if self.graph is None:
                done = min(self.WARMUP - self.warmed, n)
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for _ in range(done):
                        self.step()
                torch.cuda.current_stream(dev).wait_stream(side)
                self.warmed += done
                if done < n:
                    self.capture()
            for _ in range(n - done):
                self.graph.replay()
            launches.credit(self.replay_counts, n - done)
        return self.count.clone(), self.mean.clone(), self.m2.clone()
