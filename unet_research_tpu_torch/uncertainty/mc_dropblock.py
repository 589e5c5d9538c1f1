"""Monte-Carlo DropBlock uncertainty (twin of
unet_research_tpu/uncertainty/mc_dropblock.py).

The reference's serial batch-1 forward passes with DropBlock forced on
(uncertainty_tests/Dropblock_Uncertainty.py:22-25, 48-72) as chunked batched
forwards: each chunk draws one (S, 2) set of site keys from the engine's
generator, and members of a chunk draw different masks through their flat
batch index in the counter hash. Optional square-pad + resize first
(Dropblock_Uncertainty.py:52-61). The statistics are the per-pixel mean and
unbiased std of the masked segmentations.

JAX runs the ensemble as one jitted device program with `drop_prob`
static. Here the uniform body chunks run as one (uncertainty/ensemble.py::
EnsembleProgram): every chunk's site keys are drawn from the generator up
front, chunk by chunk in the order of the chunks, and the body's go to the
card in one (chunks, S, 2) table that the captured chunk step reads at its
device chunk index. drop_prob stays a host number baked into the capture,
as JAX compiles it static, so the program is cached per (drop_prob, chunk,
input shape): the CLIs' per-image calls replay one capture.
`program=False` runs every chunk from the host instead (the same keys and
statistics; for comparisons).

With a mesh (parallel/mesh.py, the twin of JAX's `mesh=`), a chunk whose
size the ranks divide is split: every rank draws the same site keys, runs
its size/R members at their global rows of the chunk and the members'
outputs are gathered in rank order; a chunk they do not divide (the saved
members, a remainder) runs whole on every rank, as JAX shards only those.
Every rank then runs the one-process merge on the same member outputs and
holds the same statistics, as JAX's replicated output. The body chunks
still run as the one program: its chunk step is this rank's chunk/R
members and the all_gather, and every rank merges the whole chunk.

Whether the program captures is decided when the engine is built and
exposed as `MCDropBlockEngine.captures` (ops/cuda/launches.py::
captures_on_card): on the card without a mesh or under an NCCL mesh, whose
all_gather the graph then holds; under a gloo mesh (two ranks sharing one
card) the program runs each body chunk eagerly on the card, since gloo's
collectives run on the host. On the CPU every chunk runs eagerly.
"""

from __future__ import annotations

import weakref

import torch

from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.models.unet import UNet, draw_site_keys
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.image import engine_input
from unet_research_tpu_torch.parallel.mesh import all_gather
from unet_research_tpu_torch.uncertainty.ensemble import (
    EnsembleProgram,
    chunk_layout,
    ensemble_stats,
    streaming_ensemble_batched,
)


class MCDropBlockEngine:
    """Build once per model, call `predict` per image.

    generator: the torch.Generator the site keys are drawn from (seeded 0
    when None), unless a call of `predict` passes its own; under a mesh each
    rank's generator must be seeded alike. mesh: split the chunks over its
    ranks (module docstring); its size must divide `chunk`. program: run
    the body chunks as one device program (the default), or every chunk
    from the host when False. `captures`: whether that program captures a
    CUDA graph, decided here from the device, `program` and the mesh's
    backend (module docstring)."""

    def __init__(self, model: UNet, num_iterations: int = 1000, return_num: int = 25,
                 resize: int = -1, chunk: int = 25, device=None,
                 generator: torch.Generator | None = None, mesh=None, program: bool = True):
        if mesh is not None and chunk % mesh.size:
            raise ValueError(f"chunk {chunk} must divide over the {mesh.size} ranks of the mesh")
        self.model = model
        self.mesh = mesh
        self.num_iterations = num_iterations
        self.return_num = min(return_num, num_iterations)
        self.resize = resize
        self.chunk = chunk
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.generator = generator
        self.program = program
        self.captures = self.device.type == "cuda" and launches.captures_on_card(program, mesh)
        self.programs = {}  # EnsembleProgram by (drop_prob, chunk, input shape)

    def _members(self, im, mask, keys, drop_prob: float, size: int, mesh=None):
        """The masked segmentations of `size` members of one chunk with site
        keys `keys` (this rank's size/R rows under a mesh)."""
        local = size if mesh is None else size // mesh.size
        xb = im.expand((local,) + tuple(im.shape[1:]))
        return self.model(xb, drop_prob=drop_prob, site_keys=keys, mesh=mesh) * mask

    def _chunk(self, im, mask, keys, drop_prob: float, size: int):
        """The masked segmentations of one chunk of `size` members: split
        over the mesh's ranks and gathered in rank order when they divide
        `size`, else whole on every rank."""
        mesh = self.mesh if self.mesh is not None and size % self.mesh.size == 0 else None
        out = self._members(im, mask, keys, drop_prob, size, mesh)
        return out if mesh is None else all_gather(out, mesh)

    def _program(self, drop_prob: float, shape, chunks: int) -> EnsembleProgram:
        key = (float(drop_prob), self.chunk, tuple(shape))
        prog = self.programs.get(key)
        if prog is None:
            sites = self.model.num_mask_sites()
            tables = {"keys": torch.zeros((chunks, sites, 2), dtype=torch.int64,
                                          device=self.device)}
            # the program reaches its engine weakly: a dropped engine frees
            # the program (a CUDA graph and its memory pool) at once, not
            # when the cyclic collector next runs
            engine, chunk = weakref.ref(self), self.chunk
            prog = EnsembleProgram(
                lambda p: engine()._chunk(p.image, p.mask, p.row("keys"), drop_prob, chunk),
                shape, tables, self.device, self.captures, self.mesh)
            self.programs[key] = prog
        return prog

    def predict(self, im, gt, mask, drop_prob: float, generator: torch.Generator | None = None):
        """im, gt, mask: NHWC (1, H, W, C) arrays or tensors. Returns
        (mean, std, saved, im, gt, mask): mean/std are (1, H, W, 1), saved is
        (return_num, 1, H, W, 1), the reference's tensor layout. generator:
        this call's site-key generator (the engine's own when None), as the
        JAX engine takes a key per call."""
        im, gt, mask = (engine_input(t, self.device, self.resize) for t in (im, gt, mask))
        num_sites = self.model.num_mask_sites()
        generator = self.generator if generator is None else generator

        with torch.inference_mode():
            if not self.program:
                def batch(gen, size: int):
                    keys = draw_site_keys(num_sites, gen).to(self.device)
                    return self._chunk(im, mask, keys, drop_prob, size)

                mean, std, saved = streaming_ensemble_batched(
                    batch, generator, self.num_iterations, self.chunk, self.return_num)
            else:
                layout = chunk_layout(self.num_iterations, self.chunk, self.return_num)
                keys = [draw_site_keys(num_sites, generator) for _ in layout.sizes]
                prog = None
                if layout.n_body:
                    prog = self._program(drop_prob, im.shape, layout.n_body)
                    body = keys[layout.body_start:layout.body_start + layout.n_body]
                    prog.tables["keys"].copy_(torch.stack(body))
                    prog.image.copy_(im)
                    prog.mask.copy_(mask)
                mean, std, saved = ensemble_stats(
                    lambda c, size: self._chunk(im, mask, keys[c].to(self.device), drop_prob,
                                                size),
                    layout, self.return_num, prog)
        return mean[None], std[None], saved[:, None], im, gt, mask
