"""Configurable U-Net as an nn.Module (twin of unet_research_tpu/models/unet.py).

The reference builder's layout (unet_code/utils/utils_unet.py:11-463), with
its torch state_dict keys, so a reference PL checkpoint loads as it is
(utils/convert.py of the JAX package, :8-20):

  down_blocks.{d}.0.{4i}     3x3 Conv2d        down_blocks.{d}.0.{4i+1}  norm
  down_blocks.{d}.1.0        2x2 pool conv ('conv' pooling)
  down_blocks.{d}.1.1        pool norm
  conn_block.{4i}/{4i+1}     bottleneck conv / norm
  up_blocks.{d}.0.0          ConvTranspose2d(k=2, s=2) ('upconv'), .0.1 norm
  up_blocks.{d}.0.1          3x3 Conv2d ('upsample'),              .0.2 norm
  up_blocks.{d}.1.{4i}/{4i+1} post-merge conv / norm
  output_conv.0              1x1 Conv2d head

Each conv is followed by norm -> DropBlock -> activation; the skip merge
carries one more (bare) DropBlock site, which on the fused route takes
K1's merge mode with the upconv's epilogue, the skip's deferred scale and
the concatenation where the input allows it (`_Pass.merge_site`). Norm
modules hold parameters only: GroupNorm is computed by `group_norm_affine`
(float32 statistics, the apply in the storage dtype), as in the JAX model.
On the card a bf16 GroupNorm
epilogue (norm, the mask and its rescale, the activation) runs instead as one
kernel Function, ops/cuda/group_norm.py::group_norm_act, wherever its input
lets it (`group_norm_act_supported`); a card site that cannot is counted in
`gn:plain` (ops/cuda/launches.py) and runs the plain ops. The site machinery
(the DropBlock state, the epilogue routes, remat) is models/sites.py's,
shared with models/transunet.py.

`forward(x, drop_prob=None, site_keys=None, train=False, mesh=None)` takes and
returns NHWC; under a mesh x is this rank's rows of a global batch.
`drop_prob=None` switches DropBlock off; otherwise `site_keys` is an (S, 2)
int64 tensor of uint32 key words, one row per mask site in call order (see
`num_mask_sites`), the keys the JAX model draws with `make_rng`. drop_prob
is a number, or a 0-d float32 tensor on the model's device (a train step's,
as JAX traces it from the step): each mask site then computes its seed
threshold there and the mask producer reads it from the device, so a
captured train step draws each step's masks. Activations and weights are
cast to `cfg.dtype` at use; parameters stay float32.

Mask pipelines (`DropBlockConfig.mask_impl`): 'fused' runs every site
through the fused kernel (ops/cuda/dropblock_kernel.py::dropblock_fused_apply)
when the norm is GroupNorm or None and the activation relu/leaky_relu;
'kernel' draws masks with the mask producer; 'elementwise' is the plain op.
`conv_impl='pair'` runs the eligible 3x3 convs through
ops/cuda/pair_conv.py::conv3x3_pair (VALID ones through conv3x3_pair_valid),
whose moment sums feed GroupNorm.

Training (`train=True`, train/loop.py) differentiates through every route:
conv3x3_pair is an autograd Function whose input gradient runs K3 again,
and the mask sites take the mask producer, since the fused kernel has no
backward (a fused pass under autograd raises). `cfg.remat` re-runs the conv,
pool and up blocks in the backward (torch.utils.checkpoint).
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.models.sites import (  # noqa: F401 (the U-Net's public names)
    Norm,
    SitePass,
    _nchw,
    _nhwc,
    draw_site_keys,
    group_norm_affine,
    group_norm_coeffs,
    group_norm_coeffs_from_sums,
)
from unet_research_tpu_torch.ops.cuda.dropblock_kernel import (
    dropblock_merge_apply,
    merge_apply_supported,
    merges,
)
from unet_research_tpu_torch.ops.cuda.group_norm import group_norm_act_supported
from unet_research_tpu_torch.ops.cuda.pair_conv import conv3x3_pair, conv3x3_pair_valid
from unet_research_tpu_torch.ops.image import center_crop, crop_to, pad_to_multiple
from unet_research_tpu_torch.parallel.mesh import rank_offset

_ACTIVATIONS = ("relu", "leaky_relu", "elu", "gelu", "silu", "tanh", "sigmoid", "none")


@dataclasses.dataclass(frozen=True)
class DropBlockConfig:
    """DropBlock plug-in (reference UNet.set_dropblock, utils_unet.py:117-134).

    kind: 'dependent' | 'independent' | None. mask_impl: 'fused' (the fused
    kernel at every site), 'kernel' (the mask producer) or 'elementwise'."""

    kind: Optional[str] = "dependent"
    block_size: int = 7
    drop_prob: float = 0.1
    use_scheduler: bool = True
    start_drop_prob: float = 0.0
    max_drop_prob: float = 0.2
    nr_steps: int = 500
    mask_impl: str = "fused"

    def __post_init__(self):
        if self.mask_impl not in ("elementwise", "kernel", "fused"):
            raise ValueError(f"unknown dropblock mask_impl {self.mask_impl!r}")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Constructor-arg parity with the reference UNet (utils_unet.py:14-26)
    and the JAX UNetConfig. conv_impl: 'pair' (the eligible 3x3 convs run
    through conv3x3_pair) or 'torch' (F.conv2d everywhere). remat: the conv,
    pool and up blocks keep no activations for the backward and run again
    in it (training only)."""

    init_channels: int = 3
    filters: int = 64
    output_channels: int = 1
    model_depth: int = 4
    pool_mode: str = "max"
    up_mode: str = "upconv"
    connection: str = "cat"
    same_padding: bool = True
    conv_layers_per_block: int = 2
    norm: Optional[str] = "group"
    group_norm_groups: int = 32
    activation: str = "relu"
    negative_slope: float = 0.01
    dropblock: DropBlockConfig = dataclasses.field(default_factory=DropBlockConfig)
    remat: bool = False
    dtype: torch.dtype = torch.float32
    conv_impl: str = "pair"
    fold_rescale: bool = True

    def __post_init__(self):
        if self.connection not in ("add", "cat", "none"):
            raise ValueError("Connection type must be of (add, cat, none)")
        if self.pool_mode not in ("max", "avg", "conv"):
            raise ValueError("Pool Mode must be of (max, avg, conv).")
        if self.up_mode not in ("upsample", "upconv"):
            raise ValueError("Up_Mode must be of (upsample, upconv).")
        if self.conv_layers_per_block <= 1:
            raise ValueError("Convolutional Layers in each block must be 2 or more.")
        if self.dropblock.kind not in (None, "dependent", "independent"):
            raise ValueError("dropblock.kind must be dependent/independent/None")
        if self.norm not in (None, "group", "batch"):
            raise ValueError("norm must be 'group', 'batch' or None")
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.conv_impl not in ("torch", "pair"):
            raise ValueError("conv_impl must be 'torch' or 'pair'")


def canonical_config(**overrides) -> UNetConfig:
    """The configuration every reference entry point uses: the 31M-parameter
    U-Net with GroupNorm(32) and ReLU (base_model_tests/training.py:171-192)."""
    base = dict(
        init_channels=1, filters=64, output_channels=1, model_depth=4,
        pool_mode="max", up_mode="upconv", connection="cat", same_padding=True,
        conv_layers_per_block=2, norm="group", group_norm_groups=32,
        activation="relu",
    )
    base.update(overrides)
    return UNetConfig(**base)


# --- the module ---------------------------------------------------------------

class UNet(nn.Module):
    """The full encoder/decoder (reference UNet.forward, utils_unet.py:408-449).

    device: where the parameters live, the card unless "cpu" is asked for.
    generator: a torch.Generator for a seeded torch-style initialisation
    (U(+-1/sqrt(fan_in)) for conv weights and biases, GroupNorm ones/zeros)."""

    def __init__(self, cfg: UNetConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        bias = cfg.norm is None
        pad = 1 if cfg.same_padding else 0
        n_convs = cfg.conv_layers_per_block

        def norm(c):
            if cfg.norm == "group":
                return nn.GroupNorm(cfg.group_norm_groups, c)
            if cfg.norm == "batch":
                return nn.BatchNorm2d(c)
            return nn.Identity()

        def stack(cin, cout):
            mods = []
            for i in range(n_convs):
                mods += [nn.Conv2d(cin if i == 0 else cout, cout, 3, padding=pad, bias=bias),
                         norm(cout), nn.Identity(), nn.Identity()]
            return nn.Sequential(*mods)

        filters, cin = cfg.filters, cfg.init_channels
        self.down_blocks = nn.ModuleList()
        for d in range(cfg.model_depth):
            if d > 0:
                filters *= 2
            pool0 = (nn.Conv2d(filters, filters, 2, stride=2, bias=bias)
                     if cfg.pool_mode == "conv" else nn.Identity())
            self.down_blocks.append(nn.Sequential(stack(cin, filters),
                                                  nn.Sequential(pool0, norm(filters))))
            cin = filters
        filters *= 2
        self.conn_block = stack(cin, filters)
        self.up_blocks = nn.ModuleList()
        for d in range(cfg.model_depth):
            half = filters // 2
            if cfg.up_mode == "upconv":
                up = nn.Sequential(nn.ConvTranspose2d(filters, half, 2, stride=2, bias=bias),
                                   norm(half))
            else:
                up = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(filters, half, 3, padding=pad, bias=bias),
                                   norm(half))
            merged = 2 * half if cfg.connection == "cat" else half
            self.up_blocks.append(nn.Sequential(up, stack(merged, half)))
            filters = half
        self.output_conv = nn.Sequential(nn.Conv2d(filters, cfg.output_channels, 1,
                                                   bias=bias))
        if generator is not None:
            self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded torch-style initialisation, drawn on the CPU."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                # torch's fan_in: dim 1 of the weight times the kernel area
                bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
                w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=generator))
                if mod.bias is not None:
                    mod.bias.copy_(torch.empty(mod.bias.shape).uniform_(
                        -bound, bound, generator=generator))
            elif isinstance(mod, (nn.GroupNorm, nn.BatchNorm2d)):
                mod.reset_parameters()

    def num_mask_sites(self) -> int:
        """Rows `site_keys` needs: one per conv, plus one per skip merge."""
        cfg = self.cfg
        convs = (2 * cfg.model_depth + 1) * cfg.conv_layers_per_block
        merges = cfg.model_depth if cfg.connection != "none" else 0
        return convs + merges

    def forward(self, x, drop_prob=None, site_keys=None, train: bool = False, mesh=None):
        """x: NHWC float batch -> (N, H, W, output_channels) float32 in [0, 1].

        train: the JAX model's static `train` (models/unet.py:720-724):
        BatchNorm normalises with batch statistics and updates its running
        ones, and the mask sites take the mask producer instead of the
        forward-only fused kernel. DropBlock is switched by drop_prob.
        mesh: x is this rank's rows of a global batch, every rank holding as
        many (parallel/mesh.py). The pass then computes those rows of the
        global batch's forward, as JAX's sharded model does: every mask
        site draws at the rows' global indices, and the whole-batch
        DropBlock rescale and BatchNorm's batch statistics (train mode) sum
        over the ranks. Every rank must run the same pass."""
        return _Pass(self, drop_prob, site_keys, train, mesh).run(x)


# BatchNorm's running statistics in a state_dict: JAX keeps them apart, as
# the `batch_stats` collection
_BATCH_STATS = ("running_mean", "running_var", "num_batches_tracked")


def param_count(params) -> int:
    """The number of values in `params`: a module's parameters, a mapping's
    tensors (a state_dict) or an iterable of tensors (JAX param_count on a
    param tree)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, Mapping):
        params = params.values()
    return sum(int(p.numel()) for p in params)


def as_variables(params) -> dict:
    """The load-ready state_dict from a state_dict or from a bundle
    {'params': ..., 'batch_stats': ... or None} (JAX as_variables, which
    lets every surface take one object whatever the norm; here the model's
    load_state_dict takes both parts in one mapping)."""
    if isinstance(params, Mapping) and "params" in params:
        return {**params["params"], **(params.get("batch_stats") or {})}
    return dict(params)


def split_variables(params):
    """(parameters, batch_stats or None) of a state_dict or a bundle: the
    batch_stats are BatchNorm's running statistics (JAX split_variables)."""
    v = as_variables(params)
    stats = {k: t for k, t in v.items() if k.rsplit(".", 1)[-1] in _BATCH_STATS}
    return {k: t for k, t in v.items() if k not in stats}, (stats or None)


class _Pass(SitePass):
    """One forward pass of the U-Net: the shared site machinery
    (models/sites.py) with the configuration's norm at every site, and
    fold_rescale."""

    def __init__(self, model: UNet, drop_prob, site_keys, train: bool, mesh):
        cfg = model.cfg
        super().__init__(model, cfg.dropblock, cfg.dtype, drop_prob, site_keys, train, mesh,
                         cfg.remat, cfg.activation, cfg.negative_slope)
        self.cfg = cfg
        # fold_rescale (JAX UNetConfig): needs GroupNorm and live DropBlock
        self.fold = cfg.fold_rescale and cfg.norm == "group" and self.active

    def fuses(self) -> bool:
        return self.model.cfg.norm in (None, "group")

    def norm_of(self, mod) -> Norm:
        return Norm(self.cfg.norm, mod, self.cfg.group_norm_groups, 1e-5)

    # -- layers ----------------------------------------------------------------

    def conv(self, x, mod):
        """3x3 (or any) conv of NHWC x. Returns (y, sums): sums are the
        GroupNorm moment sums when conv3x3_pair produced them, else None."""
        cfg = self.cfg
        n, h, w, c = x.shape
        if (cfg.conv_impl == "pair" and cfg.norm is not None
                and mod.kernel_size == (3, 3) and mod.out_channels <= 64
                and h % 2 == 0 and w % 2 == 0 and c % 64 == 0 and (w // 2) % 8 == 0):
            # the JAX model's compiled-path gate (models/unet.py:461-494)
            kernel = mod.weight.permute(2, 3, 1, 0).to(self.dtype).contiguous()
            xin = x.to(self.dtype).contiguous()
            if not cfg.same_padding:
                return conv3x3_pair_valid(xin, kernel), None
            if cfg.norm == "group":
                y, s1, s2 = conv3x3_pair(xin, kernel, stats=True)
                return y, (s1, s2)
            return conv3x3_pair(xin, kernel), None
        return self.torch_conv(x, mod), None

    def torch_conv(self, x, mod):
        bias = None if mod.bias is None else mod.bias.to(self.dtype)
        y = F.conv2d(_nchw(x.to(self.dtype)), mod.weight.to(self.dtype), bias,
                     stride=mod.stride, padding=mod.padding)
        return _nhwc(y)

    def norm_act(self, x, mod, sums=None, mask=None, scale=None, act: bool = True):
        """norm -> x * mask -> x * scale (the whole batch's) -> activation
        (act=False: none); mask and scale None where there are none."""
        return self.site_norm_act(x, self.norm_of(mod), sums, mask, scale, act)

    def norm_db_act(self, x, key, norm_mod, rescale: str, sums=None):
        """The conv epilogue norm -> DropBlock -> activation."""
        return self.site_norm_db_act(x, key, self.norm_of(norm_mod), rescale, sums)

    # -- blocks ----------------------------------------------------------------

    def conv_block(self, x, stack, want_scale: bool):
        """conv -> norm -> DropBlock -> act, conv_layers_per_block times. Under
        fold_rescale the last site of a block that feeds a skip merge or the
        head defers its per-sample scale; every other site skips its count.
        Runs through `block` (remat) with its site keys bound now."""
        last = self.cfg.conv_layers_per_block - 1
        keys = self.take(last + 1)

        def run(x):
            scale = None
            for i in range(last + 1):
                x, sums = self.conv(x, stack[4 * i])
                if not self.fold:
                    x = self.norm_db_act(x, keys[i], stack[4 * i + 1], "apply", sums)
                elif want_scale and i == last:
                    x, scale = self.norm_db_act(x, keys[i], stack[4 * i + 1], "defer", sums)
                else:
                    x = self.norm_db_act(x, keys[i], stack[4 * i + 1], "skip", sums)
            return (x, scale) if want_scale else x

        return self.block(run, x)

    def pool(self, x, seq):
        return self.block(lambda x: self._pool(x, seq), x)

    def _pool(self, x, seq):
        mode = self.cfg.pool_mode
        if mode == "max":
            x = _nhwc(F.max_pool2d(_nchw(x), 2, 2))
        elif mode == "avg":
            x = _nhwc(F.avg_pool2d(_nchw(x), 2, 2))
        else:
            x = self.torch_conv(x, seq[0])
        return self.norm_act(x, seq[1], act=mode == "conv")

    def up(self, x, seq):
        def run(x):
            x, sums = self.up_conv(x, seq)
            return self.norm_act(x, seq[-1], sums)

        return self.block(run, x)

    def up_conv(self, x, seq):
        """The up block before its norm (seq[-1]): the 2x2 stride-2
        transposed conv ('upconv'), or nearest x2 and a conv ('upsample').
        Returns (y, sums) as `conv` does."""
        if self.cfg.up_mode == "upconv":
            mod = seq[0]
            bias = None if mod.bias is None else mod.bias.to(self.dtype)
            return _nhwc(F.conv_transpose2d(_nchw(x), mod.weight.to(self.dtype), bias,
                                            stride=2)), None
        x = _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="nearest"))
        return self.conv(x, seq[1])

    def up_merge(self, x, seq, skip, skip_scale):
        """The up block, then the skip merge. On the fused route (forward
        only, so no remat) a merge takes K1's merge mode where `merge_site`
        allows it, counted `merge:kernel` by its wrapper; every other merge
        on that route runs the composition and counts `merge:plain`
        (ops/cuda/launches.py)."""
        if not (self.fused and self.cfg.connection != "none"):
            return self.merge(self.up(x, seq), skip, skip_scale)
        x, sums = self.up_conv(x, seq)
        out = self.merge_site(x, seq[-1], skip, skip_scale)
        if out is not None:
            return out
        merges["plain"] += 1
        return self.merge(self.norm_act(x, seq[-1], sums), skip, skip_scale)

    def merge_site(self, x, norm_mod, skip, skip_scale):
        """drop(cat([relu(norm(x)), skip * skip_scale], -1)) with the
        merge's rescale skipped, for the up block's pre-norm output x, as
        one launch of K1's merge mode (dropblock_merge_apply), or None where
        the input does not allow it: a cat merge after an upconv under
        fold_rescale, a GroupNorm ahead of ReLU that the epilogue kernels
        take, x and the skip of one size (no crop), contiguous bf16, both
        channel counts multiples of 64. The coefficients are
        group_norm_act's (`kernel_coeffs`), so the output is the
        composition's, bit for bit. skip_scale: the skip's deferred (N,)
        scale, or None."""
        norm = self.norm_of(norm_mod)
        if not (self.cfg.connection == "cat" and self.fold and self.cfg.up_mode == "upconv"
                and norm.kind == "group" and self.activation == "relu"
                and merge_apply_supported(x, skip)
                and group_norm_act_supported(x, norm.groups, "relu")):
            return None
        out, _ = dropblock_merge_apply(x, self.kernel_coeffs(x, norm), skip, skip_scale,
                                       self.take(1)[0], self.gamma(*x.shape[1:3]),
                                       self.db.block_size, self.sample_offset)
        return out

    def merge(self, x, skip, skip_scale):
        """The skip merge and its bare mask site; not rematerialised (JAX
        models/unet.py:786)."""
        conn = self.cfg.connection
        if conn == "none":
            return x
        if skip_scale is not None:
            # the encoder block's deferred per-sample scale (JAX :694-708)
            skip = skip * skip_scale.to(skip.dtype)[:, None, None, None]
        skip = center_crop(skip, (x.shape[1], x.shape[2]))
        x = torch.cat([x, skip], dim=-1) if conn == "cat" else x + skip
        return self.dropblock(x, self.take(1)[0], "skip" if self.fold else "apply")

    def run(self, x):
        cfg = self.cfg
        x = x.to(device=self.model.output_conv[0].weight.device, dtype=self.dtype)
        self.sample_offset = rank_offset(self.mesh, x.shape[0])
        x, orig_hw = pad_to_multiple(x, 2 ** cfg.model_depth)
        x = x.contiguous()
        want_skip_scale = self.fold and cfg.connection != "none"
        skips = []
        for blk in self.model.down_blocks:
            if want_skip_scale:
                x, s = self.conv_block(x, blk[0], True)
            else:
                x, s = self.conv_block(x, blk[0], False), None
            skips.append((x, s))
            x = self.pool(x, blk[1])
        x = self.conv_block(x, self.model.conn_block, False)
        head_scale = None
        for d, blk in enumerate(self.model.up_blocks):
            skip_x, skip_s = skips[-1 - d]
            x = self.up_merge(x, blk[0], skip_x, skip_s)
            if self.fold and d == cfg.model_depth - 1:
                x, head_scale = self.conv_block(x, blk[1], True)
            else:
                x = self.conv_block(x, blk[1], False)
        x = self.torch_conv(x, self.model.output_conv[0]).to(torch.float32)
        if head_scale is not None:
            # the last site's deferred scale, moved past the bias-free 1x1
            # head to just before the sigmoid
            x = x * head_scale[:, None, None, None]
        x = crop_to(torch.sigmoid(x), orig_hw)
        self.recomputing = True  # what runs from here on is a remat re-run
        return torch.nan_to_num(torch.clamp(x, 0.0, 1.0), nan=0.0)
