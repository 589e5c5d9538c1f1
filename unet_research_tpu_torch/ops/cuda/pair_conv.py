"""3x3 SAME conv with GroupNorm moment sums, kernel K3 and its plain version.

Replaces unet_research_tpu/ops/pallas/pair_conv.py::conv3x3_pair (body
`_conv_kernel`, pair_conv.py:185-331), forward only: y = conv3x3_same(x, K)
over NHWC with no bias, and optionally the float32 sums s1 = sum_{H,W} y and
s2 = sum_{H,W} y^2 per (sample, output channel) taken from the float32
accumulator before it is rounded, so GroupNorm needs no pass over y.

Source: csrc/pair_conv.cu. Bound at (16,592,576) 64->64: 402 GFLOP and
1.40 GB, 0.42 ms on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s). bf16 input
with C_in % 16 == 0 runs an implicit GEMM on the tensor cores (mma.sync
m16n8k16, float32 accumulate, an 8x32 x 64-channel tile per block); float32
and other channel counts run a CUDA-core version of the same function. The
TPU kernel's pair view is a 128-lane MXU device and is not carried over.
`conv3x3_pair_valid`, the VJP and its backward kernel come with training.

In the plain version the sums are taken from the output in x's dtype, so in
bfloat16 they differ from the kernel's pre-rounding sums by design.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_research_tpu_torch.ops.cuda.build import check, load_library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("pair_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.conv3x3_launch.restype = i
        _lib = lib
    return _lib


def conv3x3_pair_plain(x, kernel, stats: bool = False):
    """K3's plain version: F.conv2d (SAME, no bias) on the NHWC input and
    HWIO kernel, plus float32 sums of the output."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()
    if not stats:
        return y
    y32 = y.to(torch.float32)
    return y, y32.sum(dim=(1, 2)), (y32 * y32).sum(dim=(1, 2))


def conv3x3_pair(x, kernel, stats: bool = False):
    """y = conv3x3_same(x, kernel), or (y, s1, s2) with stats=True.

    x: (N, H, W, C_in) contiguous NHWC float32/bfloat16; kernel: (3, 3, C_in,
    C_out) HWIO in x's dtype. s1, s2: (N, C_out) float32 sums over (H, W) of
    the float32 accumulator. CPU tensors take the plain version."""
    n, h, w, c = x.shape
    kh, kw, kc, f = kernel.shape
    if (kh, kw) != (3, 3) or kc != c:
        raise ValueError(f"conv3x3_pair: kernel {tuple(kernel.shape)} vs input C={c}")
    if not x.is_cuda:
        return conv3x3_pair_plain(x, kernel, stats)
    if x.dtype not in _DTYPES or kernel.dtype != x.dtype:
        raise ValueError("conv3x3_pair: x and kernel must share a float32/bfloat16 dtype")
    if not (x.is_contiguous() and kernel.is_contiguous()) or kernel.device != x.device:
        raise ValueError("conv3x3_pair: x and kernel must be contiguous on one device")
    y = torch.empty((n, h, w, f), dtype=x.dtype, device=x.device)
    s1 = s2 = None
    if stats:
        s1 = torch.zeros((n, f), dtype=torch.float32, device=x.device)
        s2 = torch.zeros((n, f), dtype=torch.float32, device=x.device)
    # the kernels read the weights as (3, 3, C_out, C_in): C_in contiguous
    weights = kernel.permute(0, 1, 3, 2).contiguous()
    status = _library().conv3x3_launch(
        x.data_ptr(), weights.data_ptr(), y.data_ptr(),
        None if s1 is None else s1.data_ptr(), None if s2 is None else s2.data_ptr(),
        n, h, w, c, f, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    check(min(status, 0), "conv3x3_pair")
    conv3x3_pair.launches += 1
    conv3x3_pair.tensor_cores = status == 2
    return (y, s1, s2) if stats else y


conv3x3_pair.launches = 0
conv3x3_pair.tensor_cores = False  # which kernel the last launch ran
