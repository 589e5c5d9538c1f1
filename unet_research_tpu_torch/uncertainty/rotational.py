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
"""

from __future__ import annotations

import torch

from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.models.unet import UNet
from unet_research_tpu_torch.ops.cuda.shear_rotate import rotate_fan
from unet_research_tpu_torch.ops.image import engine_input, rotate_bilinear
from unet_research_tpu_torch.uncertainty.ensemble import streaming_ensemble

_WARPS = {"gather": rotate_bilinear, "shear": rotate_fan}


class RotationalEngine:
    """Build once per model, call `predict` per image. The model runs with
    DropBlock off (the reference CLI builds it with kind None)."""

    def __init__(self, model: UNet, num_iterations: int = 359, return_num: int = 25,
                 resize: int = -1, chunk: int = 16, warp: str = "gather", device=None):
        if warp not in _WARPS:
            raise ValueError("warp must be 'shear' or 'gather'")
        self.model = model
        self.num_iterations = num_iterations
        self.return_num = min(return_num, num_iterations)
        self.resize = resize
        self.chunk = chunk
        self.warp = warp
        self.device = resolve_device(device)

    def predict(self, im, gt, mask):
        """im, gt, mask: NHWC (1, H, W, 1) arrays or tensors. Returns
        (mean, std, saved, im, gt, mask): mean/std are (1, H, W, 1), saved is
        (return_num, 1, H, W, 1), the reference's tensor layout."""
        im, gt, mask = (engine_input(t, self.device, self.resize) for t in (im, gt, mask))
        warp = _WARPS[self.warp]
        angles = torch.arange(1, self.num_iterations + 1, dtype=torch.float32)
        if self.warp == "gather":
            # rotate_fan computes its per-member scalars on the host, so the
            # table moves to the card only for the gather warp: in one copy,
            # not one per chunk
            angles = angles.to(self.device)

        def chunk_fn(angle_chunk):
            segs = self.model(warp(im, angle_chunk)).contiguous()
            return warp(segs, -angle_chunk) * mask

        with torch.inference_mode():
            mean, std, saved = streaming_ensemble(chunk_fn, angles, self.chunk,
                                                  self.return_num)
        return mean[None], std[None], saved[:, None], im, gt, mask
