"""3x3 SAME conv with GroupNorm moment sums, kernel K3 and its plain version.

Replaces unet_research_tpu/ops/pallas/pair_conv.py::conv3x3_pair (body
`_conv_kernel`, pair_conv.py:185-331) and its custom VJP: y =
conv3x3_same(x, K) over NHWC with no bias, and optionally the float32 sums s1 = sum_{H,W} y and
s2 = sum_{H,W} y^2 per (sample, output channel) taken from the float32
accumulator before it is rounded, so GroupNorm needs no pass over y.

Source: csrc/pair_conv.cu. Bound at (16,592,576) 64->64: 402 GFLOP and
1.40 GB, 0.42 ms on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s). bf16 input
with C_in % 16 == 0, C_in <= 128 and C_out % 8 == 0 (every main-path site)
runs an implicit GEMM on Hopper's warpgroup MMA (`wgmma`, float32
accumulate), fed by TMA, persistent, with the weights read once per block
straight from the HWIO tensor; float32 and other channel counts run a
CUDA-core version of the same function. `conv3x3_pair.path` names the
kernel the last launch ran and `path_launches` counts launches by kernel.
The TPU kernel's pair view is a 128-lane MXU device and is not carried over.

Differentiable on both devices (`_Conv3x3Pair`, the twin of `_pair_vjp`,
pair_conv.py:382-410). The backward is one `conv3x3_pair_dx` call and one
wgrad: `conv3x3_pair_dx(dy, K, y, ds1, ds2)` folds the sums' cotangents
into g = dy + ds1 + 2*y*ds2 (`conv3x3_pair_fold`, one memory-bound kernel
pass) and computes dx = conv3x3_same(g, rot_transpose(K)) in one K3 launch
that reads K as rot_transpose(K) by index; it returns (dx, g). The JAX
`_dx_conv` re-enters its Pallas kernel the same way; its gate that sends a
dx of more than 64 channels to XLA follows the TPU's 128-lane MXU, and K3
takes the 128-channel dx itself. dK is one correlation of x and g in their
own dtype (`torch.nn.grad.conv2d_weight`, the library call that stands for
the XLA conv `_dkernel`; in bf16 cuDNN accumulates in float32 and rounds
once, as `preferred_element_type=f32` does). `conv3x3_pair_valid` is the
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
path_launches = {"wgmma": 0, "cuda_cores": 0}


def _library():
    global _lib
    if _lib is None:
        lib = load_library("pair_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.conv3x3_launch.restype = i
        lib.conv3x3_wgmma_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.conv3x3_wgmma_launch.restype = i
        lib.conv3x3_fold_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.conv3x3_fold_launch.restype = i
        _lib = lib
    return _lib


def _takes_wgmma(dtype, c_in: int, c_out: int) -> bool:
    """Whether a launch with these channels runs the warpgroup-MMA kernel."""
    return dtype == torch.bfloat16 and c_in % 16 == 0 and c_in <= 128 and c_out % 8 == 0


def conv3x3_pair_plain(x, kernel, stats: bool = False):
    """K3's plain version: F.conv2d (SAME, no bias) on the NHWC input and
    HWIO kernel, plus float32 sums of the output."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1).contiguous()
    if not stats:
        return y
    y32 = y.to(torch.float32)
    return y, y32.sum(dim=(1, 2)), (y32 * y32).sum(dim=(1, 2))


def _aligned(t):
    """t, contiguous and 16-byte aligned (TMA and the vector loads need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, kernel):
    if x.dtype not in _DTYPES or kernel.dtype != x.dtype:
        raise ValueError("conv3x3_pair: x and kernel must share a float32/bfloat16 dtype")
    if not (x.is_contiguous() and kernel.is_contiguous()) or kernel.device != x.device:
        raise ValueError("conv3x3_pair: x and kernel must be contiguous on one device")


def _launch(x, kernel, transposed: bool, stats: bool = False):
    """One K3 launch on CUDA tensors. transposed: x is an output cotangent and
    the conv runs with rot_transpose(kernel) (a dx). Returns (out, s1, s2)."""
    _check(x, kernel)
    n, h, w, c = x.shape
    f = kernel.shape[2] if transposed else kernel.shape[3]
    dev = x.device
    out = torch.empty((n, h, w, f), dtype=x.dtype, device=dev)
    s1 = s2 = None
    if stats:
        s1 = torch.zeros((n, f), dtype=torch.float32, device=dev)
        s2 = torch.zeros((n, f), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sums = (None, None) if s1 is None else (s1.data_ptr(), s2.data_ptr())
    if _takes_wgmma(x.dtype, c, f):
        x, kernel = _aligned(x), _aligned(kernel)
        status = _library().conv3x3_wgmma_launch(
            x.data_ptr(), kernel.data_ptr(), out.data_ptr(), *sums, n, h, w, c, f,
            int(transposed), stream)
        path = "wgmma"
    else:
        # the CUDA-core kernel reads the weights as (3, 3, C_out, C_in); for a
        # dx that is the forward kernel turned by 180 degrees
        weights = (kernel.flip(0, 1) if transposed else kernel.permute(0, 1, 3, 2)).contiguous()
        status = _library().conv3x3_launch(
            x.data_ptr(), weights.data_ptr(), out.data_ptr(), *sums, n, h, w, c, f,
            _DTYPES[x.dtype], stream)
        path = "cuda_cores"
    if status <= -1000:
        raise RuntimeError(f"conv3x3_pair: cuTensorMapEncodeTiled returned {-status - 1000}")
    check(status, "conv3x3_pair")
    path_launches[path] += 1
    (conv3x3_pair_dx if transposed else conv3x3_pair).path = path
    return out, s1, s2


def _forward(x, kernel, stats: bool):
    """K3 for CUDA tensors, the plain version for CPU tensors; no autograd."""
    if not x.is_cuda:
        return conv3x3_pair_plain(x, kernel, stats)
    y, s1, s2 = _launch(x, kernel, transposed=False, stats=stats)
    conv3x3_pair.launches += 1
    return (y, s1, s2) if stats else y


def rot_transpose(kernel):
    """The dx kernel: K'[a, b, f, c] = K[2-a, 2-b, c, f]. A 3x3 SAME conv of
    the output cotangent with K' is the input gradient of a 3x3 SAME conv
    with K (JAX `_rot_transpose`, pair_conv.py:341-345)."""
    return kernel.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_pair_fold_plain(dy, y, ds1=None, ds2=None):
    """The fold's plain version: g = dy + ds1 + 2*y*ds2 in float32, rounded
    to dy's dtype, in the order of the JAX `_pair_vjp_bwd`
    (pair_conv.py:399-402); a missing cotangent counts as zero."""
    g = dy.to(torch.float32)
    if ds1 is not None:
        g = g + ds1[:, None, None, :]
    if ds2 is not None:
        g = g + 2.0 * y.to(torch.float32) * ds2[:, None, None, :]
    return g.to(dy.dtype).contiguous()


def conv3x3_pair_fold(dy, y, ds1=None, ds2=None):
    """The sums' cotangents ds1, ds2 (N, C) float32 folded into the output
    cotangent dy (N, H, W, C): g = dy + ds1 + 2*y*ds2 (y the forward's
    output), in dy's dtype. One kernel launch on the card, counted in
    `conv3x3_pair_fold.launches`; CPU tensors take the plain version."""
    if not dy.is_cuda:
        return conv3x3_pair_fold_plain(dy, y, ds1, ds2)
    if dy.dtype not in _DTYPES or y.dtype != dy.dtype or y.shape != dy.shape:
        raise ValueError("conv3x3_pair_fold: dy and y must share a shape and a "
                         "float32/bfloat16 dtype")
    n, h, w, c = dy.shape
    dy, y = _aligned(dy), _aligned(y)
    zero = torch.zeros((n, c), dtype=torch.float32, device=dy.device)
    ds1, ds2 = ((zero if d is None else d.to(torch.float32)).contiguous() for d in (ds1, ds2))
    g = torch.empty_like(dy)
    status = _library().conv3x3_fold_launch(
        dy.data_ptr(), y.data_ptr(), ds1.data_ptr(), ds2.data_ptr(), g.data_ptr(), n, h, w, c,
        _DTYPES[dy.dtype], torch.cuda.current_stream(dy.device).cuda_stream)
    check(status, "conv3x3_pair_fold")
    conv3x3_pair_fold.launches += 1
    return g


conv3x3_pair_fold.launches = 0


def conv3x3_pair_dx_plain(dy, kernel, y=None, ds1=None, ds2=None):
    """`conv3x3_pair_dx`'s plain version: the plain fold, then
    conv3x3_pair_plain with rot_transpose(kernel). Returns (dx, g)."""
    g = dy.contiguous() if y is None else conv3x3_pair_fold_plain(dy, y, ds1, ds2)
    return conv3x3_pair_plain(g, rot_transpose(kernel).to(g.dtype)), g


def conv3x3_pair_dx(dy, kernel, y=None, ds1=None, ds2=None):
    """The input gradient of conv3x3_pair(x, kernel) for the output cotangent
    dy (N, H, W, C_out) and, with y (the forward's output) given, the sums'
    cotangents ds1, ds2 (N, C_out) float32 (None counts as zero), folded in
    first as g = dy + ds1 + 2*y*ds2. Returns (dx (N, H, W, C_in), g). On the
    card: the fold kernel (`conv3x3_pair_fold`), then one K3 launch that
    reads the kernel as rot_transpose(kernel), counted in
    `conv3x3_pair_dx.launches`; CPU tensors take the plain version."""
    if not dy.is_cuda:
        return conv3x3_pair_dx_plain(dy, kernel, y, ds1, ds2)
    g = dy.contiguous() if y is None else conv3x3_pair_fold(dy, y, ds1, ds2)
    dx, _, _ = _launch(g, kernel.to(g.dtype).contiguous(), transposed=True)
    conv3x3_pair_dx.launches += 1
    return dx, g


conv3x3_pair_dx.launches = 0
conv3x3_pair_dx.path = None


class _Conv3x3Pair(torch.autograd.Function):
    """conv3x3_pair with the VJP of the JAX `_pair_vjp` (fwd :387, bwd :393)."""

    @staticmethod
    def forward(ctx, x, kernel, stats: bool):
        out = _forward(x, kernel, stats)
        ctx.stats = stats
        ctx.save_for_backward(x, kernel, out[0] if stats else None)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy, ds1=None, ds2=None):
        x, kernel, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape[:3] + kernel.shape[3:], dtype=x.dtype, device=x.device)
        # s1 = sum y, s2 = sum y^2 over (H, W), from the float32 accumulator;
        # its bf16 rounding is taken as the identity, as in JAX
        fold = ctx.stats and (ds1 is not None or ds2 is not None)
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx, g = conv3x3_pair_dx(dy, kernel, *((y, ds1, ds2) if fold else ()))
            dx = dx.to(x.dtype)
        else:
            g = conv3x3_pair_fold(dy, y, ds1, ds2) if fold else dy.contiguous()
        if ctx.needs_input_grad[1]:
            dk = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (kernel.shape[3], kernel.shape[2], 3, 3),
                g.permute(0, 3, 1, 2), padding=1)
            dk = dk.permute(2, 3, 1, 0).to(kernel.dtype)
        return dx, dk, None


def conv3x3_pair(x, kernel, stats: bool = False):
    """y = conv3x3_same(x, kernel), or (y, s1, s2) with stats=True.

    x: (N, H, W, C_in) contiguous NHWC float32/bfloat16; kernel: (3, 3, C_in,
    C_out) HWIO in x's dtype. s1, s2: (N, C_out) float32 sums over (H, W) of
    the float32 accumulator. CPU tensors take the plain version. The
    gradient to x and kernel (and through s1, s2) is `_Conv3x3Pair`'s."""
    kh, kw, kc, _ = kernel.shape
    if (kh, kw) != (3, 3) or kc != x.shape[-1]:
        raise ValueError(f"conv3x3_pair: kernel {tuple(kernel.shape)} vs input C={x.shape[-1]}")
    return _Conv3x3Pair.apply(x, kernel, stats)


conv3x3_pair.launches = 0
conv3x3_pair.path = None  # the kernel the last forward launch ran: 'wgmma' or 'cuda_cores'


def conv3x3_pair_valid(x, kernel):
    """VALID 3x3 conv through the SAME kernel: the interior of the SAME
    output is the VALID output (JAX `conv3x3_pair_valid`, pair_conv.py:246).
    No sums: they would include the cropped border ring."""
    return conv3x3_pair(x, kernel)[:, 1:-1, 1:-1, :]
