"""DropBlock, the plain PyTorch versions (twin of unet_research_tpu/ops/dropblock.py).

The reference's two torch DropBlock variants (utils/utils_modules.py):

- dependent (``DropBlock2D``): Bernoulli(gamma) seeds over the valid-centre
  region, expanded to b x b blocks by a stride-1 max-pool, inverted, applied,
  rescaled by numel/sum (utils_modules.py:36-82);
- independent (``Dropblock2d_ichan``): seeds over the full grid with the b//2
  border zeroed, the same expansion, a zero-guarded 1/mean rescale
  (utils_modules.py:86-139).

The seeds come from the JAX package's counter hash, indexed in flat NHWC
order, so the same two key words draw bit-identical masks here, in the
hand-written kernels (ops/cuda/dropblock_kernel.py) and in the JAX
elementwise pipeline. The hash's uint32 arithmetic runs in int64 with an
explicit 32-bit wrap, since uint32 tensor ops are incomplete on the CPU.

`mask_impl`: 'elementwise' (the functions below), 'kernel' (the mask
producer, ops/cuda/dropblock_kernel.py::dropblock_mask) or 'fused' (a
model-level pipeline; at the op level it means 'kernel', as in JAX).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from unet_research_tpu_torch.parallel.mesh import psum, rank_offset

_M32 = 0xFFFFFFFF


def _resolve_impl(mask_impl) -> str:
    impl = mask_impl or "elementwise"
    if impl not in ("elementwise", "kernel", "fused"):
        raise ValueError(f"unknown dropblock mask_impl {impl!r}")
    return impl


def f32(value) -> float:
    """`value` rounded to float32 once (the gamma every mask path compares
    its float32 uniforms against)."""
    return float(np.float32(value))


def _over(a, b: int):
    """a / b. A tensor is divided by b as a tensor on its own device: CUDA
    divides by a host scalar as a * (1 / b), which can round otherwise."""
    if isinstance(a, torch.Tensor):
        return a / torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def dropblock_gamma_dependent(h: int, w: int, block_size: int, drop_prob):
    """Gamma for the dependent variant (utils_modules.py:81-82). Unclamped.
    drop_prob: a number, or a float32 tensor (then the float32 operations
    of an np.float32 drop_prob, in the same order, on its device)."""
    b = block_size
    return _over(drop_prob * h * w, (b * b) * (h - b + 1) * (w - b + 1))


def dropblock_gamma_independent(h: int, w: int, block_size: int, drop_prob):
    """Gamma for the independent-channel variant (utils_modules.py:98-102),
    clamped to 1. drop_prob: as in dropblock_gamma_dependent."""
    b = block_size
    gamma = _over(_over(drop_prob, b * b) * (h * w), (h - b + 1) * (w - b + 1))
    return gamma.clamp(max=1.0) if isinstance(gamma, torch.Tensor) else min(gamma, 1.0)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) without int64 overflow:
    c is split into 16-bit halves so every partial product stays < 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def hash_bits(key_words: torch.Tensor, shape, sample_offset: int = 0) -> torch.Tensor:
    """The counter hash's top 24 bits, int64 in [0, 2^24), on key_words'
    device: `hash_uniform` before its scaling to [0, 1)."""
    kd = key_words.reshape(-1).to(torch.int64) & _M32
    inner = 1
    for s in shape[1:]:
        inner *= int(s)
    start, stop = sample_offset * inner, (sample_offset + int(shape[0])) * inner
    if stop > 2**32:
        raise ValueError(f"hash_uniform: {stop} counters exceed the uint32 counter")
    x = torch.arange(start, stop, dtype=torch.int64, device=kd.device).reshape(tuple(shape))
    x = _mul32(x, 2654435761) ^ kd[0]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15) ^ kd[-1]
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >> 8


def hash_uniform(key_words: torch.Tensor, shape, sample_offset: int = 0) -> torch.Tensor:
    """Counter-hash uniforms in [0, 1), float32, on key_words' device.

    The murmur-style mixer of the JAX package (ops/dropblock.py:91-113) over
    the flat row-major index of `shape`, keyed by the first and last of the
    uint32 key words (an int64 tensor). Bit-identical to JAX's
    `_hash_uniform` for the same key words. sample_offset: the global index
    of row 0 (a rank's first row of a global batch): the counter starts at
    sample_offset * prod(shape[1:]), so rows [k, k+n) of an N-row draw equal
    the n-row draw at offset k, as XLA's partitioned iota gives them."""
    # 24-bit mantissa -> exact float32 uniform in [0, 1)
    return hash_bits(key_words, shape, sample_offset).to(torch.float32) * (1.0 / (1 << 24))


def _seeds(key_words, shape, gamma, sample_offset, threshold) -> torch.Tensor:
    """bool seeds u < f32(gamma) over `shape`; with `threshold` (a one-word
    integer tensor holding seed_threshold(gamma), ops/cuda/dropblock_kernel.py)
    the hash's top 24 bits below it instead: the kernels' comparison, which
    draws the same seeds for that gamma."""
    if threshold is None:
        return hash_uniform(key_words, shape, sample_offset) < f32(gamma)
    return hash_bits(key_words, shape, sample_offset) < threshold.reshape(()).to(torch.int64)


def _block_expand(seeds: torch.Tensor, block_size: int) -> torch.Tensor:
    """bool NHWC seeds -> bool NHWC blocks: stride-1 b x b max-pool with
    torch-style b//2 padding; even b crops the trailing row/column."""
    n, h, w, c = seeds.shape
    p = block_size // 2
    out = F.max_pool2d(seeds.permute(0, 3, 1, 2).to(torch.float32),
                       block_size, stride=1, padding=p)
    return out[:, :, :h, :w].permute(0, 2, 3, 1) > 0


def interior_mask(h: int, w: int, p: int, device) -> torch.Tensor:
    """bool (H, W): the seed region [p, H-1-p] x [p, W-1-p]."""
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    return (((rows >= p) & (rows <= h - 1 - p))[:, None]
            & ((cols >= p) & (cols <= w - 1 - p))[None, :])


# Counters per block of rows in dropped_blocks: the hash's int64 temporaries
# and the expansion's float32 planes take 8 and 4 bytes per counter each, so
# a large batch is drawn a block of whole rows at a time (a chunk of 16 at
# 592x576x64 is 349M counters; 2^26 bound each temporary to 0.5 GiB).
SEED_BLOCK = 1 << 26


def dropped_blocks(shape, key_words: torch.Tensor, gamma, block_size: int,
                   sample_offset: int = 0, threshold=None) -> torch.Tensor:
    """bool (N, H, W, C): the positions an odd-b DropBlock drops.

    Seeds are Bernoulli(gamma) from `hash_uniform` at the flat NHWC index,
    kept only in the interior (b//2 border excluded), then expanded to b x b
    blocks. Drawing over the full grid and masking the border equals the
    reference's valid-centre draw + zero pad for odd b (ops/dropblock.py:214-224
    of the JAX package). This is the mask both Hopper kernels compute.
    sample_offset: see hash_uniform. threshold: see _seeds (gamma is then
    not read). Rows are drawn SEED_BLOCK counters (at least one row) at a
    time, each block at its global row offset: the same bits."""
    n, h, w, c = shape
    rows = max(1, SEED_BLOCK // (h * w * c))
    interior = interior_mask(h, w, block_size // 2, key_words.device)[None, :, :, None]
    dropped = torch.empty(tuple(shape), dtype=torch.bool, device=key_words.device)
    for r in range(0, n, rows):
        block = (min(rows, n - r), h, w, c)
        seeds = _seeds(key_words, block, gamma, sample_offset + r, threshold) & interior
        dropped[r:r + block[0]] = _block_expand(seeds, block_size)
    return dropped


def _dropped(shape, key_words, gamma, block_size, sample_offset, threshold=None) -> torch.Tensor:
    if block_size % 2 == 1:
        return dropped_blocks(shape, key_words, gamma, block_size, sample_offset, threshold)
    # even b: seeds over the (H-b+1, W-b+1) valid centres in their own index
    # space, ZeroPad2d(b//2), crop the trailing row/column (JAX :225-230)
    n, h, w, c = shape
    b, p = block_size, block_size // 2
    seeds = _seeds(key_words, (n, h - b + 1, w - b + 1, c), gamma, sample_offset, threshold)
    seeds = F.pad(seeds, (0, 0, p, p, p, p))[:, :h, :w, :]
    return _block_expand(seeds, b)


def _kernel_path(impl: str, block_size: int) -> bool:
    from unet_research_tpu_torch.ops.cuda.dropblock_kernel import dropblock_kernel_supported

    return impl in ("kernel", "fused") and dropblock_kernel_supported(block_size)


def _mask_and_keep(x, key_words, gamma, block_size, impl, sample_offset, threshold=None):
    """(int8 keep-mask, per-sample keep counts float32 (N,))."""
    if _kernel_path(impl, block_size):
        from unet_research_tpu_torch.ops.cuda.dropblock_kernel import dropblock_mask

        return dropblock_mask(tuple(x.shape), key_words, gamma, block_size, sample_offset,
                              threshold=threshold)
    keep_mask = (~_dropped(tuple(x.shape), key_words, gamma, block_size,
                           sample_offset, threshold)).to(torch.int8)
    return keep_mask, keep_mask.sum(dim=(1, 2, 3)).to(torch.float32)


def dropblock_mask_scale(x: torch.Tensor, key_words: torch.Tensor, drop_prob,
                         block_size: int, kind: str, mask_impl: str | None = None,
                         rescale: str = "apply", mesh=None, threshold=None):
    """(int8 keep mask, scale) of one DropBlock site over x: what
    dropblock_dependent / dropblock_independent multiply x by (kind names
    which). scale: None under rescale 'skip', the per-sample (N,) scale under
    'defer', the whole batch's 0-d scale under 'apply'. mesh, threshold: as
    in dropblock_dependent."""
    if kind == "independent" and block_size % 2 == 0:
        raise ValueError("dropblock_independent requires an odd block_size")
    impl = _resolve_impl(mask_impl)
    n, h, w, c = x.shape
    gamma_fn = dropblock_gamma_dependent if kind == "dependent" else dropblock_gamma_independent
    gamma = None if threshold is not None else gamma_fn(h, w, block_size, drop_prob)
    keep_mask, keep = _mask_and_keep(x, key_words, gamma, block_size, impl,
                                     rank_offset(mesh, n), threshold)
    if rescale == "skip":
        return keep_mask, None
    if rescale == "defer":
        return keep_mask, keep_scale(kind, keep, float(h * w * c))
    total, numel = batch_keep(keep, n * h * w * c, mesh)
    return keep_mask, keep_scale(kind, total, numel)


def apply_keep_mask(x: torch.Tensor, keep_mask: torch.Tensor, scale, rescale: str):
    """x * keep_mask in x's dtype, then as rescale says: 'skip' returns it,
    'defer' returns (it, scale), 'apply' multiplies in scale."""
    out = x * keep_mask.to(x.dtype)
    if rescale == "skip":
        return out
    if rescale == "defer":
        return out, scale
    return out * scale.to(x.dtype)


def dropblock_dependent(x: torch.Tensor, key_words: torch.Tensor, drop_prob,
                        block_size: int, mask_impl: str | None = None,
                        rescale: str = "apply", mesh=None, threshold=None):
    """DropBlock2D-equivalent (utils_modules.py:36-82), NHWC.

    rescale: 'apply' multiplies in numel/sum over the whole batch (the
    reference op); 'defer' returns (x*mask, per-sample (N,) scale numel/sum);
    'skip' omits the count (the model's fold_rescale algebra). mesh: x is
    this rank's rows of the global batch (parallel/mesh.py): the masks are
    drawn at their global rows and 'apply' counts over the global batch.
    threshold: this site's seed threshold as a one-word integer tensor on
    x's device, in place of drop_prob (a train step's, whose drop
    probability is a device word); the same masks as its gamma."""
    keep_mask, scale = dropblock_mask_scale(x, key_words, drop_prob, block_size, "dependent",
                                            mask_impl, rescale, mesh, threshold)
    return apply_keep_mask(x, keep_mask, scale, rescale)


def dropblock_independent(x: torch.Tensor, key_words: torch.Tensor, drop_prob,
                          block_size: int, mask_impl: str | None = None,
                          rescale: str = "apply", mesh=None, threshold=None):
    """Dropblock2d_ichan-equivalent (utils_modules.py:107-139), NHWC: the
    guarded 1/mean rescale (identity when everything was dropped). Odd b
    only, as in the reference. mesh, threshold: as in dropblock_dependent."""
    keep_mask, scale = dropblock_mask_scale(x, key_words, drop_prob, block_size, "independent",
                                            mask_impl, rescale, mesh, threshold)
    return apply_keep_mask(x, keep_mask, scale, rescale)


def batch_keep(keep: torch.Tensor, numel: int, mesh):
    """(kept positions, positions) of the whole batch from the per-sample
    keep counts and the batch's numel: the global batch's under a mesh, where
    every rank holds as many rows."""
    if mesh is None:
        return keep.sum(), float(numel)
    return psum(keep.sum(), mesh), float(numel * mesh.size)


def keep_scale(kind: str, kept: torch.Tensor, numel: float) -> torch.Tensor:
    """The rescale for `kept` of `numel` positions: numel/kept for the
    dependent variant, the zero-guarded 1/(kept/numel) for the independent
    one (identity when everything was dropped)."""
    if kind == "dependent":
        return numel / kept
    frac = kept / numel
    return torch.where(frac != 0, 1.0 / frac, torch.ones_like(frac))


def linear_drop_prob(step: int, start: float, stop: float, nr_steps: int) -> float:
    """Drop-prob of the dropblock package's LinearScheduler at `step`
    (np.linspace(start, stop, nr_steps), held at `stop` afterwards;
    reference utils_unet.py:129-132, 410-411)."""
    if nr_steps <= 1:
        return float(stop)
    i = min(float(step), nr_steps - 1)
    return start + (stop - start) * i / (nr_steps - 1)
