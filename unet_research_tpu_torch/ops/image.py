"""Image geometry ops, NHWC layout (twin of unet_research_tpu/ops/image.py).

What the engines and the generator need: the model's autopad/crop pair,
the skip center-crop, the `-resize` square-pad + bilinear resize, the
rotational engine's default warp `rotate_bilinear`, and the augmentation
generator's gray conversion, flips and cv2-style rotations
(`rotate_cv2_like`). The rotations share one source-map builder
(`_rotation_maps`) and the two gathers; each rotates a batch by K angles
in one call where the JAX functions take one angle under vmap.
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


def _members(img: torch.Tensor, k: int, source) -> torch.Tensor:
    """(K, 1) index of the image of the NHWC batch `img` that each of K maps
    samples: `source` when given, else member k (a batch of K) or image 0."""
    if source is not None:
        return torch.as_tensor(source, device=img.device).to(torch.int64)[:, None]
    if img.shape[0] == k:
        return torch.arange(k, device=img.device)[:, None]
    return torch.zeros((k, 1), dtype=torch.int64, device=img.device)


def _bilinear_gather_2d(img: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor,
                        border: str = "zeros", source=None) -> torch.Tensor:
    """Sample NHWC `img` bilinearly at per-member fractional maps src_y,
    src_x of shape (K, H', W') -> (K, H', W', C); map k samples image
    source[k] (see `_members`). border='zeros': out-of-canvas taps
    contribute 0 (grid_sample's padding_mode='zeros'); 'replicate': taps
    clamp to the edge (cv2 BORDER_REPLICATE). JAX
    ops/image.py::_bilinear_gather_2d, per member."""
    n, h, w, c = img.shape
    k, oh, ow = src_y.shape
    y0 = torch.floor(src_y)
    x0 = torch.floor(src_x)
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)
    flat = img.reshape(n, h * w, c)
    member = _members(img, k, source)

    def tap(yi, xi):
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat[member, idx.reshape(k, -1)].reshape(k, oh, ow, c)
        if border == "zeros":
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            vals = vals * valid[..., None].to(img.dtype)
        return vals

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def _nearest_gather_2d(img: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor,
                       border: str = "replicate", source=None) -> torch.Tensor:
    """Nearest-neighbour sample of NHWC `img` at per-member maps (K, H', W'),
    rounding half up, floor(src + 0.5), as JAX ops/image.py::
    _nearest_gather_2d does; borders and `source` as in
    _bilinear_gather_2d."""
    n, h, w, c = img.shape
    k, oh, ow = src_y.shape
    yi = torch.floor(src_y + 0.5).to(torch.int64)
    xi = torch.floor(src_x + 0.5).to(torch.int64)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    vals = img.reshape(n, h * w, c)[_members(img, k, source), idx.reshape(k, -1)]
    vals = vals.reshape(k, oh, ow, c)
    if border == "zeros":
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = vals * valid[..., None].to(img.dtype)
    return vals


def _rotation_maps(img: torch.Tensor, angles_deg, cy: float, cx: float):
    """The per-member source maps (K, H, W) of CCW rotations of `img`'s
    canvas by K angles in degrees about (cx, cy): degrees to radians, cos
    and sin in float32, as the JAX functions compute them."""
    n, h, w, _ = img.shape
    a = torch.as_tensor(angles_deg).to(device=img.device, dtype=torch.float32).reshape(-1)
    a = (a * _DEG2RAD)[:, None, None]
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    cos_a, sin_a = torch.cos(a), torch.sin(a)
    # inverse map of a CCW rotation in image coordinates (y points down)
    src_x = cos_a * xx - sin_a * yy + cx
    src_y = sin_a * xx + cos_a * yy + cy
    return src_y, src_x


def rotate_bilinear(img: torch.Tensor, angles_deg) -> torch.Tensor:
    """Rotate a (1 or K, H, W, C) NHWC batch by K angles in degrees, CCW
    about ((W-1)/2, (H-1)/2), bilinear, zero fill -> (K, H, W, C): the
    torchvision rotate the reference calls (Rotational_Uncertainty.py:54-58),
    as JAX ops/image.py::rotate_bilinear computes it per angle. A batch of K
    rotates member k by angle k. The four taps are an explicit gather, not
    F.grid_sample, whose coordinate normalisation rounds differently."""
    n, h, w, c = img.shape
    src_y, src_x = _rotation_maps(img, angles_deg, (h - 1) / 2.0, (w - 1) / 2.0)
    if n not in (1, src_y.shape[0]):
        raise ValueError("img batch must be 1 or len(angles)")
    return _bilinear_gather_2d(img, src_y, src_x)


def rotate_cv2_like(img: torch.Tensor, angles_deg, interpolation: str = "bilinear",
                    border: str = "replicate", source=None) -> torch.Tensor:
    """Rotate NHWC images the cv2/albumentations way by K angles in degrees
    -> (K, H, W, C): CCW about the absolute centre (W/2, H/2), BORDER_REPLICATE
    by default, bilinear for images and nearest for masks and targets (the
    generator's A.Rotate(limit=180, border_mode=1), reference
    preprocessing/create_augmentations.py:51-58; JAX
    ops/image.py::rotate_cv2_like per angle). Member k rotates image
    source[k] of the batch, or image k of a batch of K, or the one image.
    An angle of 0 samples every pixel at its own centre, so it returns the
    input exactly."""
    n, h, w, c = img.shape
    src_y, src_x = _rotation_maps(img, angles_deg, h / 2.0, w / 2.0)
    if source is None and n not in (1, src_y.shape[0]):
        raise ValueError("img batch must be 1 or len(angles), or pass source")
    gather = _bilinear_gather_2d if interpolation == "bilinear" else _nearest_gather_2d
    return gather(img, src_y, src_x, border=border, source=source)


def flip_nhwc(img: torch.Tensor, code: int) -> torch.Tensor:
    """cv2.flip semantics on NHWC: 0 = vertical (about the x axis), 1 =
    horizontal, -1 = both (A.Flip draws the code uniformly,
    create_augmentations.py:52-53)."""
    dims = {0: (1,), 1: (2,), -1: (1, 2)}.get(code)
    if dims is None:
        raise ValueError("flip code must be -1, 0 or 1")
    return img.flip(dims)


def to_gray_rgb(img: torch.Tensor) -> torch.Tensor:
    """A.ToGray on uint8-valued RGB (NHWC float holding 0..255): cv2's
    fixed-point RGB2GRAY, Y = (R*4899 + G*9617 + B*1868 + 8192) >> 14, exact
    in float32, repeated to 3 channels."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = torch.floor((r * 4899.0 + g * 9617.0 + b * 1868.0 + 8192.0) / 16384.0)
    return y[..., None].expand(*y.shape, 3).contiguous()


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
