"""DropBlock kernels K1 (fused apply) and K2 (mask producer) and their plain
versions.

Replaces unet_research_tpu/ops/pallas/dropblock_kernel.py:
- `dropblock_fused_apply` <- `dropblock_fused_apply` (body `_fused_kernel`,
  dropblock_kernel.py:245-344): out = act((x*a + b) * keep_mask) and the
  per-sample keep counts in one pass over x;
- `dropblock_mask` <- `dropblock_pallas_mask` (body `_mask_kernel`,
  dropblock_kernel.py:204-225, 347-386): the dense int8 keep-mask and the
  keep counts, reading no x.

K1 has a merge mode, `dropblock_merge_apply`: a U-Net skip merge's bare mask
site over cat([relu(GroupNorm(u)), skip * scale], -1), read from the up
block's pre-norm output u and the skip and written once, with the
arithmetic of the composition it replaces (`gn_apply` with ReLU, the bf16
multiply, the concatenation, K1's bare site). Its launches count on
`dropblock_fused_apply.launches` (one more mask site through K1); which
merges take it and which the composition is counted in `merges`.

Source: csrc/dropblock.cu. Both are bound by memory: K1 moves 2 bytes/element
each way in bf16 (0.42 ms at the top site (16,592,576,64) on an H100 SXM at
3.35 TB/s), K2 writes 1 byte/element (0.10 ms). A block owns a 64-channel
slice of a 32x64 tile (32x32 for b != 7), hashes each halo position's 64
channels in one thread, and applies 8 channels per thread with 16-byte
accesses. The mask is the odd-b
DropBlock of ops/dropblock.py::dropped_blocks, drawn from the same counter
hash at the flat NHWC index, so kernel, plain version and the JAX
elementwise pipeline agree bit for bit given the same two key words. (The
TPU kernels use the TPU's hardware PRNG and a 16-bit gamma, and match only
in distribution.)
"""

from __future__ import annotations

import ctypes
import math

import torch

from unet_research_tpu_torch.ops.cuda.build import check, load_library
from unet_research_tpu_torch.ops.cuda.group_norm import gn_apply_plain
from unet_research_tpu_torch.ops.dropblock import dropped_blocks, f32

_ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
# skip merges under the fused route by route: a launch of K1's merge mode
# (counted by dropblock_merge_apply), or the composition (counted by
# models/unet.py::_Pass.up_merge); a CUDA graph replays them without calling
# either, so whoever replays one credits the counts (ops/cuda/launches.py,
# as `merge:kernel` / `merge:plain`)
merges = {"kernel": 0, "plain": 0}


def dropblock_kernel_supported(block_size: int) -> bool:
    return block_size % 2 == 1 and 1 < block_size <= 17


def _library():
    global _lib
    if _lib is None:
        lib = load_library("dropblock")
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.dropblock_fused_apply_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, u, i, i, f, i, p]
        lib.dropblock_fused_apply_launch.restype = i
        lib.dropblock_mask_launch.argtypes = [p, p, p, i, i, i, i, i, u, p, i, p]
        lib.dropblock_mask_launch.restype = i
        lib.dropblock_merge_apply_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, u,
                                                     i, p]
        lib.dropblock_merge_apply_launch.restype = i
        _lib = lib
    return _lib


def seed_threshold(gamma):
    """The kernels' integer form of `u < gamma`: a seed where the hash's top
    24 bits are below ceil(gamma * 2^24), gamma rounded to float32 first
    (the product is exact in double precision). A tensor gamma gives the
    same number as an int64 tensor on its device (the product is exact in
    float32 too)."""
    if isinstance(gamma, torch.Tensor):
        scaled = torch.ceil(gamma.to(torch.float32) * float(1 << 24))
        return scaled.clamp(0, 1 << 24).to(torch.int64)
    return min(max(math.ceil(f32(gamma) * float(1 << 24)), 0), 1 << 24)


def _check_args(shape, key_words, block_size, sample_offset):
    if not dropblock_kernel_supported(block_size):
        raise ValueError("dropblock kernel requires odd 1 < block_size <= 17")
    if len(shape) != 4:
        raise ValueError(f"expected an NHWC shape, got {tuple(shape)}")
    n, h, w, c = shape
    if sample_offset < 0 or (sample_offset + n) * h * w * c >= 2**32:
        raise ValueError("dropblock kernel: the global flat NHWC index must fit in uint32")
    if tuple(key_words.shape) != (2,) or key_words.dtype != torch.int64:
        raise ValueError("key_words must be an int64 tensor of shape (2,)")


def _apply_act(y, act: str, slope: float):
    if act == "relu":
        return torch.relu(y)
    if act == "leaky_relu":
        return torch.where(y > 0, y, y * slope)
    if act == "none":
        return y
    raise ValueError(f"unsupported activation {act!r}")


def dropblock_fused_apply_plain(x, ab, key_words, gamma, block_size: int,
                                act: str = "relu", slope: float = 0.01, sample_offset: int = 0):
    """K1's plain version: the same function in PyTorch ops. x*a and then +b
    are each rounded in x's dtype, as the JAX GroupNorm apply does."""
    n, h, w, c = x.shape
    dropped = dropped_blocks(tuple(x.shape), key_words, gamma, block_size, sample_offset)
    y = x
    if ab is not None:
        y = (x * ab[0].to(x.dtype)[:, None, None, :]) + ab[1].to(x.dtype)[:, None, None, :]
    y = _apply_act(torch.where(dropped, torch.zeros((), dtype=x.dtype, device=x.device), y),
                   act, slope)
    keep = (h * w * c - dropped.sum(dim=(1, 2, 3))).to(torch.float32)
    return y, keep


def dropblock_fused_apply(x, ab, key_words, gamma, block_size: int,
                          act: str = "relu", slope: float = 0.01, sample_offset: int = 0):
    """act((x*a + b) * keep_mask) and per-sample keep counts in one pass.

    x: (N, H, W, C) float32/bfloat16, contiguous NHWC. ab: (2, N, C) float32
    GroupNorm-affine coefficients, or None (the bare skip-merge site).
    key_words: int64 (2,) holding two uint32 words, on x's device. gamma: the
    seed probability (rounded to float32). sample_offset: the global index
    of sample 0 (a rank's first row of a global batch), where its hash
    counters start; rows [k, k+n) of an N-sample launch equal the n-sample
    launch at offset k. Returns (out in x.dtype, keep (N,) float32). Forward
    only. CPU tensors take the plain version."""
    _check_args(x.shape, key_words, block_size, sample_offset)
    if act not in _ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    if not x.is_cuda:
        return dropblock_fused_apply_plain(x, ab, key_words, gamma, block_size, act, slope,
                                           sample_offset)
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError("dropblock_fused_apply: x must be contiguous NHWC float32/bfloat16")
    n, h, w, c = x.shape
    if ab is not None:
        if tuple(ab.shape) != (2, n, c) or ab.dtype != torch.float32 \
                or not ab.is_contiguous() or ab.device != x.device:
            raise ValueError("dropblock_fused_apply: ab must be contiguous (2, N, C) float32")
    if key_words.device != x.device:
        raise ValueError("dropblock_fused_apply: key_words must be on x's device")
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel moves 8 channels with one 16-byte access
    out = torch.empty_like(x)
    keep = torch.zeros(n, dtype=torch.int64, device=x.device)
    status = _library().dropblock_fused_apply_launch(
        x.data_ptr(), out.data_ptr(), None if ab is None else ab.data_ptr(),
        keep.data_ptr(), key_words.data_ptr(), n, h, w, c, sample_offset, seed_threshold(gamma),
        block_size,
        _ACTS[act], float(slope), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "dropblock_fused_apply")
    dropblock_fused_apply.launches += 1
    return out, keep.to(torch.float32)


dropblock_fused_apply.launches = 0


def dropblock_merge_apply_plain(x, ab, skip, skip_scale, key_words, gamma, block_size: int,
                                sample_offset: int = 0):
    """K1's merge mode in plain ops: the composition it replaces. relu(x*a +
    b) in float32 rounded once (gn_apply's plain version), the skip times
    its scale rounded to the skip's dtype, the two concatenated, then K1's
    bare site (no affine, no activation)."""
    y = gn_apply_plain(x, ab, act="relu")
    if skip_scale is not None:
        skip = skip * skip_scale.to(skip.dtype)[:, None, None, None]
    return dropblock_fused_apply_plain(torch.cat([y, skip], dim=-1), None, key_words, gamma,
                                       block_size, "none", sample_offset=sample_offset)


def merge_apply_supported(x, skip) -> bool:
    """Whether the merge mode takes these inputs: contiguous bf16 NHWC
    tensors of one card and one batch and spatial size, both channel counts
    multiples of 64 (a block's 64-channel slice lies in one input)."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4 and x.is_contiguous()
            and skip.device == x.device and skip.dtype == x.dtype and skip.dim() == 4
            and skip.is_contiguous() and tuple(skip.shape[:3]) == tuple(x.shape[:3])
            and x.shape[-1] % 64 == 0 and skip.shape[-1] % 64 == 0)


def dropblock_merge_apply(x, ab, skip, skip_scale, key_words, gamma, block_size: int,
                          sample_offset: int = 0):
    """K1's merge mode: drop(cat([relu(x*a + b), skip * scale], -1)) and the
    per-sample keep counts of the concatenation, in one pass.

    x: (N, H, W, C1) bf16, the up block's output before its GroupNorm; ab:
    (2, N, C1) float32, that GroupNorm's coefficients; skip: (N, H, W, C2)
    bf16; skip_scale: (N,) float32 (rounded to bf16 before the multiply), or
    None for none. key_words, gamma, block_size and sample_offset as in
    dropblock_fused_apply, the seeds at the concatenation's flat index.
    Returns (out (N, H, W, C1 + C2) bf16, keep (N,) float32), bit-equal to
    dropblock_merge_apply_plain. Forward only; a launch counts on
    dropblock_fused_apply and in `merges["kernel"]`. CPU tensors take the
    plain version; raises on card inputs the kernel does not take
    (merge_apply_supported)."""
    n, h, w, c1 = x.shape
    c2 = skip.shape[-1]
    _check_args((n, h, w, c1 + c2), key_words, block_size, sample_offset)
    if not x.is_cuda:
        return dropblock_merge_apply_plain(x, ab, skip, skip_scale, key_words, gamma,
                                           block_size, sample_offset)
    if not merge_apply_supported(x, skip):
        raise ValueError("dropblock_merge_apply: x and skip must be contiguous bf16 NHWC of one "
                         "card, batch and size, C1 and C2 multiples of 64")
    if tuple(ab.shape) != (2, n, c1) or ab.dtype != torch.float32 or not ab.is_contiguous() \
            or ab.device != x.device:
        raise ValueError("dropblock_merge_apply: ab must be contiguous (2, N, C1) float32")
    if skip_scale is not None:
        if tuple(skip_scale.shape) != (n,) or skip_scale.dtype != torch.float32 \
                or skip_scale.device != x.device:
            raise ValueError("dropblock_merge_apply: skip_scale must be (N,) float32 on x's "
                             "device")
        skip_scale = skip_scale.contiguous()
    if key_words.device != x.device:
        raise ValueError("dropblock_merge_apply: key_words must be on x's device")
    x = x if x.data_ptr() % 16 == 0 else x.clone()
    skip = skip if skip.data_ptr() % 16 == 0 else skip.clone()
    out = torch.empty((n, h, w, c1 + c2), dtype=x.dtype, device=x.device)
    keep = torch.zeros(n, dtype=torch.int64, device=x.device)
    status = _library().dropblock_merge_apply_launch(
        x.data_ptr(), skip.data_ptr(), out.data_ptr(), ab.data_ptr(),
        None if skip_scale is None else skip_scale.data_ptr(), keep.data_ptr(),
        key_words.data_ptr(), n, h, w, c1, c2, sample_offset, seed_threshold(gamma), block_size,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "dropblock_merge_apply")
    dropblock_fused_apply.launches += 1
    merges["kernel"] += 1
    return out, keep.to(torch.float32)


def dropblock_mask_plain(shape, key_words, gamma, block_size: int, sample_offset: int = 0,
                         threshold=None):
    """K2's plain version: int8 keep-mask (N, H, W, C) and keep counts."""
    keep_mask = (~dropped_blocks(tuple(shape), key_words, gamma, block_size,
                                 sample_offset, threshold)).to(torch.int8)
    return keep_mask, keep_mask.sum(dim=(1, 2, 3)).to(torch.float32)


def _check_threshold(threshold, device) -> None:
    if threshold.numel() != 1 or threshold.dim() > 1 \
            or threshold.dtype not in (torch.int64, torch.uint32):
        raise ValueError("threshold must be a 0-d or (1,) int64/uint32 tensor")
    if threshold.device != device:
        raise ValueError("dropblock_mask: threshold must be on key_words' device")


def dropblock_mask(shape, key_words, gamma, block_size: int, sample_offset: int = 0,
                   threshold=None):
    """Dense int8 keep-mask (N, H, W, C) and keep counts (N,) float32, on
    key_words' device, with the samples at global rows sample_offset + n (as
    in dropblock_fused_apply). threshold: seed_threshold(gamma) as a 0-d or
    (1,) int64/uint32 tensor on key_words' device, which the kernel reads
    from the device in place of gamma (a captured train step computes it
    there at each replay); the same mask as that gamma. CPU key words take the plain
    version."""
    _check_args(shape, key_words, block_size, sample_offset)
    if threshold is not None:
        _check_threshold(threshold, key_words.device)
    if not key_words.is_cuda:
        return dropblock_mask_plain(shape, key_words, gamma, block_size, sample_offset,
                                    threshold)
    n, h, w, c = (int(s) for s in shape)
    mask = torch.empty((n, h, w, c), dtype=torch.int8, device=key_words.device)
    keep = torch.zeros(n, dtype=torch.int64, device=key_words.device)
    # the kernel reads one 32-bit word: the value itself, or an int64's low
    # word (little-endian; a threshold is at most 2^24)
    status = _library().dropblock_mask_launch(
        mask.data_ptr(), keep.data_ptr(), key_words.data_ptr(), n, h, w, c, sample_offset,
        0 if threshold is not None else seed_threshold(gamma),
        None if threshold is None else threshold.data_ptr(), block_size,
        torch.cuda.current_stream(key_words.device).cuda_stream)
    check(status, "dropblock_mask")
    dropblock_mask.launches += 1
    return mask, keep.to(torch.float32)


dropblock_mask.launches = 0
