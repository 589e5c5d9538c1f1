"""Compute ops: image geometry, DropBlock and the losses; hand-written
kernels live in `ops.cuda`."""

from unet_research_tpu_torch.ops.dropblock import (
    dropblock_dependent,
    dropblock_gamma_dependent,
    dropblock_gamma_independent,
    dropblock_independent,
    linear_drop_prob,
)
from unet_research_tpu_torch.ops.image import (
    center_crop,
    crop_to,
    pad_to_multiple,
    resize_bilinear,
    rotate_bilinear,
    square_pad,
)
from unet_research_tpu_torch.ops.losses import bce_loss, masked_rescaled_bce

__all__ = ["bce_loss", "center_crop", "crop_to", "dropblock_dependent",
           "dropblock_gamma_dependent", "dropblock_gamma_independent", "dropblock_independent",
           "linear_drop_prob", "masked_rescaled_bce", "pad_to_multiple", "resize_bilinear",
           "rotate_bilinear", "square_pad"]
