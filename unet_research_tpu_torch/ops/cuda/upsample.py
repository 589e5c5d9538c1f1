"""Bilinear x2 upsampling (align_corners) written straight into the skip
concatenation, as one hand-written kernel, and its plain version.

    upsample_merge(x, skip) = cat([bilinear_x2(x), pad_bottom_right(skip)], -1)

for NHWC x (N, h, w, C) and skip (N, hs, ws, Cs), hs <= 2h, ws <= 2w: the
merge of each TransUNet decoder block (models/transunet.py; the last block
has no skip). `upsample_merge` picks the route from its inputs: the kernel
(`upsample_concat`, csrc/upsample.cu, design and bound there) for contiguous
bf16 or float32 tensors on the card with C and Cs multiples of 8, C at least
16, and an exact x2 (`upsample_concat_supported`), else the plain composition
(`upsample_concat_plain`: F.interpolate, F.pad, torch.cat, as the decoder
ran them before). Each call adds one to `calls["kernel"]` or
`calls["plain"]`; a CUDA graph replays the kernel without calling this
module, so whoever replays one credits the counts (ops/cuda/launches.py, as
`up:kernel` / `up:plain`), and the wrapper's launches likewise.

The kernel's arithmetic is aten's NHWC bilinear kernel's, so its output is
bit-equal to the plain route on the card; aten takes that kernel for a
channels-last input of at least 16 channels (its other kernel, below 16,
fuses other multiply-adds), hence the gate's 16. Under autograd the kernel route is
a Function whose backward is the plain ops' gradients: aten's bilinear
backward of the first C channels, and the rest cropped to the skip. It
replaces no TPU kernel: TransUNet exists only in the port.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_research_tpu_torch.ops.cuda.build import check, load_library

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
calls = {"kernel": 0, "plain": 0}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("upsample")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.upsample_concat_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        lib.upsample_concat_launch.restype = i
        _lib = lib
    return _lib


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def upsample_concat_plain(x, skip=None, size=None):
    """The plain composition: x bilinearly upsampled (align_corners) by 2, or
    to `size` (H, W), then skip zero-padded at its bottom and right to the
    same size and concatenated after x's channels in x's dtype."""
    if size is None:
        y = F.interpolate(_nchw(x), scale_factor=2, mode="bilinear", align_corners=True)
    else:
        y = F.interpolate(_nchw(x), size=tuple(size), mode="bilinear", align_corners=True)
    y = _nhwc(y).contiguous()
    if skip is None:
        return y
    hh, ww = y.shape[1:3]
    skip = F.pad(skip, (0, 0, 0, ww - skip.shape[2], 0, hh - skip.shape[1]))
    return torch.cat([y, skip.to(y.dtype)], dim=-1)


def upsample_concat_supported(x, skip=None, size=None) -> bool:
    """Whether the kernel takes these inputs: contiguous non-empty NHWC
    tensors of one dtype, bf16 or float32, on one card, C and Cs multiples of
    8, C at least 16, the skip no larger than the output, and an exact x2."""
    if not (x.is_cuda and x.dtype in _DTYPES and x.dim() == 4 and x.is_contiguous()
            and x.numel() > 0 and x.shape[-1] % 8 == 0 and x.shape[-1] >= 16):
        return False
    n, h, w, _ = x.shape
    if size is not None and tuple(size) != (2 * h, 2 * w):
        return False
    return skip is None or (
        skip.device == x.device and skip.dtype == x.dtype and skip.dim() == 4
        and skip.is_contiguous() and skip.shape[0] == n and skip.shape[1] <= 2 * h
        and skip.shape[2] <= 2 * w and skip.shape[-1] % 8 == 0)


def _aligned(t):
    return t if t.data_ptr() % 16 == 0 else t.clone()


def upsample_concat(x, skip=None):
    """cat([bilinear_x2(x), pad(skip)], -1) through the kernel (its plain
    version for CPU tensors); raises on card inputs the kernel does not take."""
    if not x.is_cuda:
        return upsample_concat_plain(x, skip)
    if not upsample_concat_supported(x, skip):
        raise ValueError("upsample_concat: x and skip must be contiguous NHWC bf16 or float32 "
                         "of one dtype on one card, C % 8 == 0 and C >= 16, the skip at "
                         "most 2h x 2w")
    n, h, w, c = x.shape
    hs, ws, cs = (0, 0, 0) if skip is None else skip.shape[1:]
    out = torch.empty((n, 2 * h, 2 * w, c + cs), dtype=x.dtype, device=x.device)
    x = _aligned(x)
    skip = None if skip is None else _aligned(skip)
    check(_library().upsample_concat_launch(
        x.data_ptr(), None if skip is None else skip.data_ptr(), out.data_ptr(), n, h, w, c,
        hs, ws, cs, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream),
        "upsample_concat")
    upsample_concat.launches += 1
    return out


upsample_concat.launches = 0


class _UpsampleConcat(torch.autograd.Function):
    """The kernel forward; the plain ops' gradients backward."""

    @staticmethod
    def forward(ctx, x, skip):
        ctx.x_shape = tuple(x.shape)
        ctx.skip_hw = None if skip is None else tuple(skip.shape[1:3])
        return upsample_concat(x, skip)

    @staticmethod
    def backward(ctx, g):
        n, h, w, c = ctx.x_shape
        gx = gskip = None
        if ctx.needs_input_grad[0]:
            gx = _nhwc(torch.ops.aten.upsample_bilinear2d_backward(
                _nchw(g[..., :c]), [2 * h, 2 * w], [n, c, h, w], True, None, None))
        if ctx.skip_hw is not None and ctx.needs_input_grad[1]:
            hs, ws = ctx.skip_hw
            gskip = g[:, :hs, :ws, c:]
        return gx, gskip


def upsample_merge(x, skip=None, size=None):
    """cat([bilinear upsampling of x by 2 (or to `size`), skip padded], -1)
    through the kernel where it takes the inputs, else the plain
    composition; counts the route in `calls`. Differentiable in x and skip."""
    if upsample_concat_supported(x, skip, size):
        calls["kernel"] += 1
        return _UpsampleConcat.apply(x, skip)
    calls["plain"] += 1
    return upsample_concat_plain(x, skip, size)
