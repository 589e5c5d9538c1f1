"""Rotational test-time-augmentation uncertainty (twin of
unet_research_tpu/uncertainty/rotational.py).

The reference's 359 serial rotate -> forward -> unrotate passes
(uncertainty_tests/Rotational_Uncertainty.py:36-68) as chunked batched
forwards over the angle fan 1..num_iterations degrees. Per chunk: warp the
image by +angles, one batched forward, warp each member's segmentation back
by its -angle, multiply by the mask. Optional square-pad + resize first
(Rotational_Uncertainty.py:40-48).

Warps:
- 'gather' (default): ops/image.py::rotate_bilinear, the torchvision-parity
  bilinear warp, as in the reference;
- 'shear': ops/cuda/shear_rotate.py::rotate_fan (kernel K4 on the card),
  the three-shear fan warp of the JAX package's `-warp shear` mode, which
  differs from bilinear by about 1e-3 mean abs on smooth content.

JAX runs the ensemble as one jitted device program. Here the uniform body
chunks run as one (uncertainty/ensemble.py::EnsembleProgram), cached per
(chunk, input shape): its tables hold the body's angles ('gather', read at
the device chunk index by plain ops) or the K4 member rows of the body's
forward and inverse fans ('shear', built once on the host by fan_params,
read by `rotate_fan_table` at the device chunk index). The other chunks
warp from the host as before. `program=False` runs every chunk from the
host (the same statistics; for comparisons).
"""

from __future__ import annotations

import weakref

import torch

from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.models.unet import UNet
from unet_research_tpu_torch.ops.cuda.shear_rotate import member_table, rotate_fan, rotate_fan_table
from unet_research_tpu_torch.ops.image import engine_input, rotate_bilinear
from unet_research_tpu_torch.spans import span
from unet_research_tpu_torch.uncertainty.ensemble import (
    EnsembleProgram,
    chunk_layout,
    ensemble_stats,
)

_WARPS = {"gather": rotate_bilinear, "shear": rotate_fan}


class RotationalEngine:
    """Build once per model, call `predict` per image. The model runs with
    DropBlock off (the reference CLI builds it with kind None). program:
    run the body chunks as one device program (the default), or every chunk
    from the host when False."""

    def __init__(self, model: UNet, num_iterations: int = 359, return_num: int = 25,
                 resize: int = -1, chunk: int = 16, warp: str = "gather", device=None,
                 program: bool = True):
        if warp not in _WARPS:
            raise ValueError("warp must be 'shear' or 'gather'")
        self.model = model
        self.num_iterations = num_iterations
        self.return_num = min(return_num, num_iterations)
        self.resize = resize
        self.chunk = chunk
        self.warp = warp
        self.device = resolve_device(device)
        self.program = program
        self.programs = {}  # EnsembleProgram by (chunk, input shape)

    def _members(self, im, mask, warp_in, warp_out):
        """The masked segmentations of one chunk: warp_in of the image, the
        batched forward, warp_out of each segmentation."""
        segs = self.model(warp_in(im)).contiguous()
        return warp_out(segs) * mask

    def _program(self, shape, body) -> EnsembleProgram:
        """The program of the body chunks' angles `body` (chunks, chunk)."""
        key = (self.chunk, tuple(shape))
        prog = self.programs.get(key)
        if prog is not None:
            return prog
        # the program reaches its engine weakly: a dropped engine frees the
        # program (a CUDA graph and its memory pool) at once, not when the
        # cyclic collector next runs
        engine = weakref.ref(self)
        if self.warp == "gather":
            def members(p):
                a = p.row("angles")
                return engine()._members(p.image, p.mask, lambda x: rotate_bilinear(x, a),
                                         lambda x: rotate_bilinear(x, -a))

            tables = {"angles": body.to(self.device)}
        else:
            h, w = shape[1], shape[2]

            def members(p):
                fans = p.tables
                return engine()._members(p.image, p.mask,
                                         lambda x: rotate_fan_table(x, fans["forward"], p.index),
                                         lambda x: rotate_fan_table(x, fans["inverse"], p.index))

            # K4's member tables (ops/cuda/shear_rotate.py::MemberTable)
            tables = {"forward": member_table(list(body), h, w, self.device),
                      "inverse": member_table(list(-body), h, w, self.device)}
        prog = self.programs[key] = EnsembleProgram(members, shape, tables, self.device)
        return prog

    def predict(self, im, gt, mask):
        """im, gt, mask: NHWC (1, H, W, 1) arrays or tensors. Returns
        (mean, std, saved, im, gt, mask): mean/std are (1, H, W, 1), saved is
        (return_num, 1, H, W, 1), the reference's tensor layout."""
        with span("engine.predict"):
            with span("engine.input"):
                im, gt, mask = (engine_input(t, self.device, self.resize) for t in (im, gt, mask))
            warp = _WARPS[self.warp]
            host_angles = torch.arange(1, self.num_iterations + 1, dtype=torch.float32)
            # rotate_fan computes its per-member scalars on the host, so the
            # angles move to the card only for the gather warp: in one copy,
            # not one per chunk
            angles = host_angles.to(self.device) if self.warp == "gather" else host_angles
            layout = chunk_layout(self.num_iterations, self.chunk, self.return_num)
            starts = [sum(layout.sizes[:c]) for c in range(len(layout.sizes))]

            def outputs(c: int, size: int):
                a = angles[starts[c]:starts[c] + size]
                return self._members(im, mask, lambda x: warp(x, a), lambda x: warp(x, -a))

            prog = None
            with torch.inference_mode():
                if self.program and layout.n_body:
                    first = starts[layout.body_start]
                    body = host_angles[first:first + layout.n_body * self.chunk]
                    prog = self._program(im.shape, body.reshape(layout.n_body, self.chunk))
                    with span("engine.fill"):
                        prog.image.copy_(im)
                        prog.mask.copy_(mask)
                mean, std, saved = ensemble_stats(outputs, layout, self.return_num, prog)
            return mean[None], std[None], saved[:, None], im, gt, mask
