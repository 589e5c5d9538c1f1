"""The plain reference of the benchmark's model: the canonical U-Net with
dependent DropBlock, in float32 PyTorch with TF32 off.

Written from the published description and kept apart from the program
under test, whose package this file never imports:

- Ronneberger et al. 2015 (arXiv:1505.04597): depth 4, filters 64 to 1024,
  3x3 SAME convolutions, 2x2 max-pool, 2x2 stride-2 up-convolutions,
  concatenated skips, a 1x1 head and a sigmoid;
- as JohnDLee/Unet-Research builds it (base_model_tests/training.py:171-192,
  unet_code/utils/utils_unet.py): GroupNorm(32) after every conv, up-conv
  and max-pool, bias-free convs, ReLU after the convs and up-convs (not after
  the pool's norm), norm -> DropBlock -> ReLU at every conv, one more bare
  DropBlock site on each concatenated skip merge, the input zero-padded at
  the bottom and right to a multiple of 16 and the output cropped back;
- DropBlock2D (utils/utils_modules.py:36-82): Bernoulli(gamma) seeds over the
  valid centres, gamma = p*H*W / (b^2 (H-b+1)(W-b+1)), expanded to b x b
  blocks, x * keep * numel/kept. Each sample is rescaled by its own count:
  the reference scores and trains one image per forward, and the
  configuration states the per-sample rescale for a batch.

The seeds are drawn by the counter hash that the configuration names
(`hash_bits`): a murmur-style mixer over the flat NHWC index of each site's
tensor, keyed by two uint32 words per site, its top 24 bits compared with
ceil(gamma * 2^24). It runs here in int32 with wrapping products and masked
(logical) shifts.

Parameters are a mapping from the reference's state-dict names to float32
tensors (`param_specs` lists them). `quant` (the control) keeps every
activation and weight in float8 (e4m3, its cotangent in e5m2).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5


def param_specs(cfg: dict) -> list:
    """[(name, shape, init)] of the model's parameters in state-dict order:
    init is 'conv' (U(+-1/sqrt(fan_in)), torch's default bound), 'one' or
    'zero' (GroupNorm's weight and bias)."""
    f, depth, cin = cfg["filters"], cfg["model_depth"], cfg["init_channels"]
    specs = []

    def norm(prefix, c):
        specs.extend([(f"{prefix}.weight", (c,), "one"), (f"{prefix}.bias", (c,), "zero")])

    def stack(prefix, cin, cout):
        for i in range(2):
            specs.append((f"{prefix}.{4 * i}.weight", (cout, cin if i == 0 else cout, 3, 3),
                          "conv"))
            norm(f"{prefix}.{4 * i + 1}", cout)

    filters = f
    for d in range(depth):
        if d > 0:
            filters *= 2
        stack(f"down_blocks.{d}.0", cin, filters)
        norm(f"down_blocks.{d}.1.1", filters)
        cin = filters
    filters *= 2
    stack("conn_block", cin, filters)
    for d in range(depth):
        half = filters // 2
        specs.append((f"up_blocks.{d}.0.0.weight", (filters, half, 2, 2), "conv"))
        norm(f"up_blocks.{d}.0.1", half)
        stack(f"up_blocks.{d}.1", 2 * half, half)
        filters = half
    specs.append(("output_conv.0.weight", (cfg["output_channels"], filters, 1, 1), "conv"))
    return specs


def num_sites(cfg: dict) -> int:
    """Mask sites: two per conv block, one per skip merge."""
    return 2 * (2 * cfg["model_depth"] + 1) + cfg["model_depth"]


# --- the counter hash and the DropBlock masks ---------------------------------

def _i32(word: int) -> int:
    """A uint32 word as the int32 with the same bits."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


def hash_bits(k0: int, k1: int, shape, sample_offset: int = 0, device=None) -> torch.Tensor:
    """The hash's top 24 bits (int32 in [0, 2^24)) at the flat row-major
    indices of `shape`, starting at sample_offset * prod(shape[1:])."""
    inner = math.prod(int(s) for s in shape[1:])
    start = sample_offset * inner
    stop = start + int(shape[0]) * inner
    if stop <= 1 << 31:
        x = torch.arange(start, stop, dtype=torch.int32, device=device)
    else:
        x = torch.arange(start, stop, dtype=torch.int64, device=device)
        x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    x = x.reshape(tuple(shape))

    def shift_xor(x, bits):  # x ^= x >>> bits (a logical shift)
        x.bitwise_xor_((x >> bits).bitwise_and_((1 << (32 - bits)) - 1))

    x.mul_(_i32(2654435761)).bitwise_xor_(_i32(k0))
    shift_xor(x, 16)
    x.mul_(_i32(0x7FEB352D))
    shift_xor(x, 15)
    x.bitwise_xor_(_i32(k1)).mul_(_i32(0x846CA68B))
    shift_xor(x, 16)
    return (x >> 8).bitwise_and_(0xFFFFFF)


def threshold(gamma) -> int:
    """ceil(gamma * 2^24), gamma rounded to float32 first."""
    return min(max(math.ceil(float(np.float32(gamma)) * float(1 << 24)), 0), 1 << 24)


def gamma_of(p, h: int, w: int, b: int):
    """DropBlock2D's gamma. p: a Python float (double arithmetic), or an
    np.float32 (float32 arithmetic, as a drop probability held on a device
    as a float32 word is computed there)."""
    denom = (b * b) * (h - b + 1) * (w - b + 1)
    if isinstance(p, np.float32):
        return np.float32(np.float32(p * np.float32(h)) * np.float32(w)) / np.float32(denom)
    return p * h * w / denom


def keep_mask(shape, k0: int, k1: int, thresh: int, block: int, sample_offset: int,
              device) -> torch.Tensor:
    """float32 (N, C, H, W) keep-mask of the NHWC-indexed `shape`: seeds where
    the hash's bits are below `thresh`, in the valid centres only, grown to
    block x block squares."""
    n, h, w, c = shape
    p = block // 2
    seeds = hash_bits(k0, k1, shape, sample_offset, device) < thresh
    seeds = seeds.permute(0, 3, 1, 2).to(torch.float32)
    inner = torch.zeros((h, w), dtype=torch.float32, device=device)
    inner[p:h - p, p:w - p] = 1.0
    # a block x block max as a column max then a row max (the same maximum)
    dropped = F.max_pool2d(seeds * inner, (block, 1), stride=1, padding=(p, 0))
    dropped = F.max_pool2d(dropped, (1, block), stride=1, padding=(0, p))
    return 1.0 - dropped


# --- the forward ----------------------------------------------------------------

class Drop:
    """The DropBlock state of one forward: per-site key words (S, 2), the drop
    probability, the block size and the global row of the batch's first
    sample."""

    def __init__(self, keys, drop_prob, block: int, sample_offset: int = 0):
        self.keys = [(int(a), int(b)) for a, b in torch.as_tensor(keys).tolist()]
        self.drop_prob, self.block, self.offset = drop_prob, block, sample_offset

    def __call__(self, x: torch.Tensor, site: int) -> torch.Tensor:
        n, c, h, w = x.shape
        k0, k1 = self.keys[site]
        thresh = threshold(gamma_of(self.drop_prob, h, w, self.block))
        keep = keep_mask((n, h, w, c), k0, k1, thresh, self.block, self.offset, x.device)
        kept = keep.sum(dim=(1, 2, 3), keepdim=True)
        return x * keep * ((c * h * w) / kept)


def fake_quant(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` with a per-tensor scale that maps its largest
    magnitude to the format's largest finite value, and back to float32."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Quant(torch.autograd.Function):
    """Forward: fake_quant to float8 e4m3; backward: the cotangent to e5m2
    (the usual split of float8 training)."""

    @staticmethod
    def forward(ctx, x):
        return fake_quant(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fake_quant(g, torch.float8_e5m2)


def forward(params: dict, x: torch.Tensor, cfg: dict, drop: Drop | None = None,
            quant: bool = False) -> torch.Tensor:
    """x: NHWC float32 (N, H, W, C) -> (N, H, W, 1) float32 in [0, 1].
    drop: the DropBlock state, or None for DropBlock off. quant: the
    control, which keeps the input, every weight and every layer's output in
    float8 (e4m3) and their cotangents in e5m2, where the program keeps them
    in bf16."""
    p = params
    depth = cfg["model_depth"]
    h0, w0 = x.shape[1], x.shape[2]
    m = 2 ** depth
    site = 0

    def store(t):
        return _Quant.apply(t) if quant else t

    def conv(x, name, **kw):
        return store(F.conv2d(x, store(p[name]), **kw))

    def gn(x, prefix):
        return F.group_norm(x, cfg["group_norm_groups"], p[f"{prefix}.weight"],
                            p[f"{prefix}.bias"], EPS)

    def dropped(x):
        nonlocal site
        if drop is not None:
            x = drop(x, site)
        site += 1
        return x

    def block(x, prefix):
        for i in range(2):
            x = conv(x, f"{prefix}.{4 * i}.weight", padding=1)
            x = store(torch.relu(dropped(gn(x, f"{prefix}.{4 * i + 1}"))))
        return x

    x = store(F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (0, -w0 % m, 0, -h0 % m)))
    skips = []
    for d in range(depth):
        x = block(x, f"down_blocks.{d}.0")
        skips.append(x)
        x = store(gn(F.max_pool2d(x, 2, 2), f"down_blocks.{d}.1.1"))
    x = block(x, "conn_block")
    for d in range(depth):
        x = store(F.conv_transpose2d(x, store(p[f"up_blocks.{d}.0.0.weight"]), stride=2))
        x = store(torch.relu(gn(x, f"up_blocks.{d}.0.1")))
        skip = skips[-1 - d]
        top, left = (skip.shape[2] - x.shape[2]) // 2, (skip.shape[3] - x.shape[3]) // 2
        skip = skip[:, :, top:top + x.shape[2], left:left + x.shape[3]]
        x = store(dropped(torch.cat([x, skip], dim=1)))
        x = block(x, f"up_blocks.{d}.1")
    x = torch.sigmoid(conv(x, "output_conv.0.weight"))[:, :, :h0, :w0]
    return torch.nan_to_num(torch.clamp(x, 0.0, 1.0), nan=0.0).permute(0, 2, 3, 1)


def model_flops(cfg: dict, h: int, w: int) -> float:
    """2 x the multiply-adds of every conv, up-conv and the head of one
    forward on the padded h x w canvas (an up-conv's at its input's size)."""
    depth = cfg["model_depth"]
    macs = 0
    for name, shape, init in param_specs(cfg):
        if init != "conv":
            continue
        level = level_of(name, depth)
        if name.startswith("up_blocks.") and name.endswith(".0.0.weight"):
            level += 1
        macs += math.prod(shape) * (h >> level) * (w >> level)
    return 2.0 * macs


def level_of(name: str, depth: int) -> int:
    """The resolution level (0 = full) at which a conv's output lies."""
    if name.startswith("down_blocks."):
        return int(name.split(".")[1])
    if name.startswith("conn_block."):
        return depth
    if name.startswith("up_blocks."):
        return depth - 1 - int(name.split(".")[1])
    return 0
