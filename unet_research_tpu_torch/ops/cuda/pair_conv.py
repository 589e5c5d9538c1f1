"""3x3 SAME conv with GroupNorm moment sums, kernel K3 and its plain version.

Replaces unet_research_tpu/ops/pallas/pair_conv.py::conv3x3_pair (body
`_conv_kernel`, pair_conv.py:185-331) and its custom VJP: y =
conv3x3_same(x, K) over NHWC with no bias, and optionally the float32 sums s1 = sum_{H,W} y and
s2 = sum_{H,W} y^2 per (sample, output channel) taken from the float32
accumulator before it is rounded, so GroupNorm needs no pass over y.

Source: csrc/pair_conv.cu. Bound at (16,592,576) 64->64: 402 GFLOP and
1.40 GB, 0.42 ms on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s). bf16 input
with C_in % 16 == 0 runs an implicit GEMM on the tensor cores (mma.sync
m16n8k16, float32 accumulate, an 8x32 x 64-channel tile per block); float32
and other channel counts run a CUDA-core version of the same function. The
TPU kernel's pair view is a 128-lane MXU device and is not carried over.

Differentiable on both devices (`_Conv3x3Pair`, the twin of `_pair_vjp`,
pair_conv.py:382-410): the backward folds the sums' cotangents into
g = dy + ds1 + 2*y*ds2, runs dx = conv3x3_pair(g, rot_transpose(K)), which
is K3 itself on the card (`conv3x3_pair_dx`; the JAX `_dx_conv` re-enters
its Pallas kernel the same way), and takes dK as one correlation of x and
g in their own dtype (`torch.nn.grad.conv2d_weight`, the library call that
stands for the XLA conv `_dkernel`; in bf16 cuDNN accumulates in float32
and rounds once, as `preferred_element_type=f32` does). The JAX gate that sends a dx of more than 64
channels to XLA (`_dx_conv`, :373-376) follows the TPU's 128-lane MXU; the
CUDA kernel takes any C_out, so every dx runs on K3 (the same function).
Bound of the backward at (1,592,576,64)->64: dx and dK are 25 GFLOP each
and it must move ~175 MB, 0.05 ms on an H100 SXM; dx on K3 is about a
sixteenth of the batch-16 forward, and the fold and dK run as plain and
library passes (times in PERF.md). `conv3x3_pair_valid` is the
SAME conv with its border ring cropped.

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


def _forward(x, kernel, stats: bool, dx: bool):
    """K3 for CUDA tensors, the plain version for CPU tensors; no autograd.
    A launch counts to `conv3x3_pair_dx` when it computes a dx, else to
    `conv3x3_pair`."""
    n, h, w, c = x.shape
    f = kernel.shape[-1]
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
    (conv3x3_pair_dx if dx else conv3x3_pair).launches += 1
    conv3x3_pair.tensor_cores = status == 2
    return (y, s1, s2) if stats else y


def rot_transpose(kernel):
    """The dx kernel: K'[a, b, f, c] = K[2-a, 2-b, c, f]. A 3x3 SAME conv of
    the output cotangent with K' is the input gradient of a 3x3 SAME conv
    with K (JAX `_rot_transpose`, pair_conv.py:341-345)."""
    return kernel.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_pair_dx(g, kernel):
    """dx = conv3x3_pair(g, rot_transpose(kernel)): K3 on the card, its
    launches counted in `conv3x3_pair_dx.launches`, apart from the forward's."""
    return conv3x3_pair(g.contiguous(), rot_transpose(kernel), dx=True)


conv3x3_pair_dx.launches = 0


class _Conv3x3Pair(torch.autograd.Function):
    """conv3x3_pair with the VJP of the JAX `_pair_vjp` (fwd :387, bwd :393)."""

    @staticmethod
    def forward(ctx, x, kernel, stats: bool, dx: bool):
        out = _forward(x, kernel, stats, dx)
        ctx.stats = stats
        ctx.save_for_backward(x, kernel, out[0] if stats else None)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy, ds1=None, ds2=None):
        x, kernel, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape[:3] + kernel.shape[3:], dtype=x.dtype, device=x.device)
        g = dy
        if ctx.stats and (ds1 is not None or ds2 is not None):
            # s1 = sum y, s2 = sum y^2 over (H, W), from the float32
            # accumulator; its bf16 rounding is taken as the identity, as in JAX
            g = dy.to(torch.float32)
            if ds1 is not None:
                g = g + ds1[:, None, None, :]
            if ds2 is not None:
                g = g + 2.0 * y.to(torch.float32) * ds2[:, None, None, :]
            g = g.to(dy.dtype)
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_pair_dx(g, kernel).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dk = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (kernel.shape[3], kernel.shape[2], 3, 3),
                g.permute(0, 3, 1, 2), padding=1)
            dk = dk.permute(2, 3, 1, 0).to(kernel.dtype)
        return dx, dk, None, None


def conv3x3_pair(x, kernel, stats: bool = False, dx: bool = False):
    """y = conv3x3_same(x, kernel), or (y, s1, s2) with stats=True.

    x: (N, H, W, C_in) contiguous NHWC float32/bfloat16; kernel: (3, 3, C_in,
    C_out) HWIO in x's dtype. s1, s2: (N, C_out) float32 sums over (H, W) of
    the float32 accumulator. CPU tensors take the plain version. The
    gradient to x and kernel (and through s1, s2) is `_Conv3x3Pair`'s.
    dx=True marks the call as a backward's dx for the launch counts."""
    kh, kw, kc, _ = kernel.shape
    if (kh, kw) != (3, 3) or kc != x.shape[-1]:
        raise ValueError(f"conv3x3_pair: kernel {tuple(kernel.shape)} vs input C={x.shape[-1]}")
    return _Conv3x3Pair.apply(x, kernel, stats, dx)


conv3x3_pair.launches = 0
conv3x3_pair.tensor_cores = False  # which kernel the last launch ran


def conv3x3_pair_valid(x, kernel):
    """VALID 3x3 conv through the SAME kernel: the interior of the SAME
    output is the VALID output (JAX `conv3x3_pair_valid`, pair_conv.py:246).
    No sums: they would include the cropped border ring."""
    return conv3x3_pair(x, kernel)[:, 1:-1, 1:-1, :]
