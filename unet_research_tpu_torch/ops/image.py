"""Image geometry ops, NHWC layout (twin of unet_research_tpu/ops/image.py).

What the two uncertainty engines need: the model's autopad/crop pair, the
skip center-crop, the `-resize` square-pad + bilinear resize, and the
rotational engine's default warp `rotate_bilinear`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_DEG2RAD = np.float32(np.pi / 180)


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


def engine_input(img, device, resize: int) -> torch.Tensor:
    """An engine's NHWC input (array or tensor) as float32 on `device`,
    square-padded and resized to resize x resize unless resize is -1 (the
    reference's `-resize`)."""
    img = torch.as_tensor(img, dtype=torch.float32).to(device)
    if resize != -1:
        img = resize_bilinear(square_pad(img), (resize, resize))
    return img


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


def _bilinear_gather_2d(img: torch.Tensor, src_y: torch.Tensor,
                        src_x: torch.Tensor) -> torch.Tensor:
    """Sample NHWC `img` (N = 1 or K) bilinearly at per-member fractional
    maps src_y, src_x of shape (K, H', W'); out-of-canvas taps contribute 0
    (JAX ops/image.py::_bilinear_gather_2d, border='zeros')."""
    n, h, w, c = img.shape
    k, oh, ow = src_y.shape
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)
    flat = img.reshape(n, h * w, c)
    member = (torch.arange(k, device=img.device) if n == k
              else torch.zeros(k, dtype=torch.int64, device=img.device))[:, None]

    def tap(yi, xi):
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat[member, idx.reshape(k, -1)].reshape(k, oh, ow, c)
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return vals * valid[..., None].to(img.dtype)

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def rotate_bilinear(img: torch.Tensor, angles_deg) -> torch.Tensor:
    """Rotate a (1 or K, H, W, C) NHWC batch by K angles in degrees, CCW
    about ((W-1)/2, (H-1)/2), bilinear, zero fill -> (K, H, W, C): the
    torchvision rotate the reference calls (Rotational_Uncertainty.py:54-58),
    as JAX ops/image.py::rotate_bilinear computes it per angle. A batch of K
    rotates member k by angle k. The four taps are an explicit gather, not
    F.grid_sample, whose coordinate normalisation rounds differently."""
    n, h, w, c = img.shape
    a = torch.as_tensor(angles_deg).to(device=img.device, dtype=torch.float32)
    k = a.shape[0]
    if n not in (1, k):
        raise ValueError("img batch must be 1 or len(angles)")
    a = (a * _DEG2RAD)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    cos_a, sin_a = torch.cos(a), torch.sin(a)
    # inverse map of a CCW rotation in image coordinates (y points down)
    src_x = cos_a * xx - sin_a * yy + cx
    src_y = sin_a * xx + cos_a * yy + cy
    return _bilinear_gather_2d(img, src_y, src_x)


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
