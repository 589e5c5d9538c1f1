"""Image geometry ops, NHWC layout (twin of unet_research_tpu/ops/image.py).

Only what the MC-DropBlock path needs: the model's autopad/crop pair, the
skip center-crop, and the `-resize` square-pad + bilinear resize.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) images to `size` = (H, W), with
    ``F.interpolate(mode='bilinear', align_corners=False, antialias=False)``
    numerics (torchvision's tensor resize in the reference)."""
    if img.ndim == 3:
        return resize_bilinear(img[None], size)[0]
    if img.ndim != 4:
        raise ValueError(f"expected HWC or NHWC, got shape {tuple(img.shape)}")
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(int(size[0]), int(size[1])),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).contiguous()


def square_pad(img: torch.Tensor) -> torch.Tensor:
    """Zero-pad NHWC images to a max(H, W) square with the reference's
    asymmetric split (utils/utils_general.py:32-43): height gives the extra
    pixel to the bottom, width gives it to the left."""
    h, w = img.shape[-3], img.shape[-2]
    size = max(h, w)
    top = (size - h) // 2
    bot = size - h - top
    right = (size - w) // 2
    left = size - w - right
    return F.pad(img, (0, 0, left, right, top, bot))


def pad_to_multiple(img: torch.Tensor, multiple: int):
    """Zero-pad NHWC bottom/right so H and W are multiples of `multiple`
    (the model-input autopad, reference utils/utils_unet.py:451-458).
    Returns the padded image and the original (H, W) for `crop_to`."""
    h, w = img.shape[-3], img.shape[-2]
    return F.pad(img, (0, 0, 0, -w % multiple, 0, -h % multiple)), (h, w)


def crop_to(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Crop NHWC from the top-left back to `size` = (H, W)."""
    h, w = size
    return img[..., :h, :w, :]


def center_crop(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Center-crop NHWC to `size` = (H, W) with torchvision CenterCrop's
    even/odd split; crop sizes larger than the input raise."""
    h, w = img.shape[-3], img.shape[-2]
    th, tw = size
    if th > h or tw > w:
        raise ValueError(f"center_crop target {size} larger than input {(h, w)}")
    top = (h - th) // 2
    left = (w - tw) // 2
    return img[..., top:top + th, left:left + tw, :]
