"""Swin UNETR (Hatamizadeh et al. 2022, arXiv:2201.01266) as an nn.Module,
with the study's DropBlock plug-in.

Built as MONAI builds it (monai/networks/nets/swin_unetr.py::SwinUNETR with
spatial_dims=2, use_v2=False, downsample "merging", normalize=True; the
blocks of monai/networks/blocks/unetr_block.py and dynunet_block.py), at the
paper's widths (feature size 48, MONAI's default 24):

- input: a 1-channel frame zero-padded at the bottom and right to a multiple
  of 32 (MONAI asks every side to divide by 2^5) and the output cropped
  back;
- patch embedding: Conv2d(in -> fs, kernel 2, stride 2, with bias): x0;
- four stages of `depths` Swin blocks at C = fs 2^s channels with `heads`
  heads of C / heads each: x = x + WA(LN1(x)), x = x + fc2(GELU(fc1(LN2(x))))
  with a 4C MLP, LayerNorms eps 1e-5; each stage ends in a patch merge
  (the 2 x 2 neighbours concatenated to 4C, LayerNorm, Linear(4C -> 2C, no
  bias)) whose output is x1..x4;
- window attention WA: 7 x 7 windows, clipped to a grid side that is no
  longer (get_window_size; the shift is 0 there); the normed grid zero-padded
  at its bottom and right to a multiple of the window, the pad tokens taking
  part as keys and values; every second block rolls the grid by (-3, -3)
  first and back after, and adds compute_mask's -100.0 between tokens from
  different regions; per window softmax(q k^T / sqrt(d) + B_rel [+ mask]) v
  with a learned (13 x 13, heads) relative-position table, qkv and proj
  Linear with bias. A clipped window of T tokens indexes the table by the
  first T rows and columns of the 7 x 7 window's index, as MONAI does;
- the hidden states x0..x4 LayerNormed over channels with no affine
  (proj_out);
- the CNN: enc0 = E1(input), enc1..enc3 = E2..E4(x0..x2), dec4 = E10(x4),
  then D5(dec4, x3), D4(., enc3), D3(., enc2), D2(., enc1), D1(., enc0) and
  a 1 x 1 conv with bias to one output and a sigmoid (the study's vessel
  map; published: BraTS's 3 sigmoid channels). E* are UnetResBlocks: y =
  lrelu(IN1(conv3x3(x))), y = IN2(conv3x3(y)), out = lrelu(y + r), r =
  IN3(conv1x1(x)) where the channels change, else x; D* are UnetrUpBlocks:
  ConvTranspose2d(2, stride 2), the upsample and the skip concatenated, a
  UnetResBlock(2C -> C). Every conv is bias-free, IN is InstanceNorm (no
  affine, eps 1e-5), lrelu's slope 0.01.

The study's plug-in is dependent (or independent) DropBlock with the U-Net's
per-site gamma and counter-hash masks (models/sites.py) at 15 sites in call
order: norm -> mask -> lrelu at IN1 of each of the 10 residual blocks, and
one bare site on each decoder concatenation. The Swin encoder holds none.
No site rescales: each one's output reaches only bias-free convs, each
followed by an InstanceNorm (IN1 of a residual block through lrelu and
conv2 to IN2; a concatenation through conv1 and conv3 to IN1 and IN3), and
IN(conv(lrelu(s x))) = IN(conv(x)) for a per-sample s > 0, up to the eps
(the U-Net's fold_rescale).

`forward(x, drop_prob=None, site_keys=None, train=False, mesh=None)` is the
U-Net's contract (models/unet.py): NHWC in and out, float32 parameters and
`cfg.dtype` at use, `cfg.remat` honoured (each Swin block and each residual
block). The Swin's residual stream is float32, its LayerNorms' outputs and
its linear layers in `cfg.dtype`. On the card the routes are:

- the IN1 + lrelu mask sites take K1 in eval with DropBlock on (the
  InstanceNorm coefficients from `gn_stats` and `gn_stats_finish`, as
  GroupNorm(C, C) with weight 1 and bias 0), the mask producer K2 and
  GroupNorm's epilogue kernels in training, and `group_norm_act` with
  leaky_relu with DropBlock off;
- IN2 and IN3 take `group_norm_act` with no activation (or the plain ops,
  counted in `gn:plain`);
- window attention is SDPA held to its memory-efficient backend with the
  relative-position bias and the mask as an additive bias
  (ops/attention.py::attention), counted in `attn:efficient` /
  `attn:other`. The bias is gathered from the table once a forward and
  block; the windows lie window-major in SDPA's head dimension so that the
  bias broadcasts over the batch;
- LayerNorm, the roll, the window partition (one gather each way, from an
  index that holds the pad, the roll and the partition) and the merge are
  plain torch ops; convs and linears are cuDNN's and cuBLAS's, the head's
  in float32 (the logit, from the bf16 activations).

The relative-position index, the shift mask and the gather indices are
built once per grid size (`SwinUNETR.geometry`), so that a captured forward
holds no host work of theirs. The spans `model.swin`, `model.encoder` and
`model.decoder` (spans.py) mark an eager forward's parts; a replayed graph
records none.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.models.sites import Norm, SitePass, _nchw, _nhwc
from unet_research_tpu_torch.models.unet import DropBlockConfig
from unet_research_tpu_torch.ops.attention import attention
from unet_research_tpu_torch.ops.image import crop_to, pad_to_multiple
from unet_research_tpu_torch.parallel.mesh import rank_offset
from unet_research_tpu_torch.spans import span

LN_EPS, IN_EPS, MASKED = 1e-5, 1e-5, -100.0
MULTIPLE = 32  # patch 2 and four merges


@dataclasses.dataclass(frozen=True)
class SwinUNETRConfig:
    """The model's widths and depths, by default the paper's feature size 48
    (MONAI's model zoo "base"), depths (2, 2, 2, 2), heads (3, 6, 12, 24),
    window 7, MLP ratio 4, one input and one output, with the DropBlock
    plug-in and the routes. The patch is 2 and the stages four: the decoder
    is built for them."""

    input_channels: int = 1
    output_channels: int = 1
    feature_size: int = 48
    depths: tuple = (2, 2, 2, 2)
    heads: tuple = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: int = 4
    dropblock: DropBlockConfig = dataclasses.field(default_factory=DropBlockConfig)
    remat: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.depths) != 4 or len(self.heads) != 4:
            raise ValueError("Swin UNETR has four stages")
        if any((self.feature_size << s) % h for s, h in enumerate(self.heads)):
            raise ValueError("each stage's channels must divide into its heads")
        if self.window < 2:
            raise ValueError("window must be at least 2")
        if self.dropblock.kind not in (None, "dependent", "independent"):
            raise ValueError("dropblock.kind must be dependent/independent/None")


def window_geometry(h: int, w: int, window: int) -> tuple:
    """((window h, w), (shift h, w)) of a shifted block on an h x w grid:
    the window clipped to a side no longer than it, the shift 0 there
    (MONAI's get_window_size)."""
    ws, ss = [window, window], [window // 2, window // 2]
    for i, side in enumerate((h, w)):
        if side <= window:
            ws[i], ss[i] = side, 0
    return tuple(ws), tuple(ss)


def relative_position_index(window: int) -> torch.Tensor:
    """(window^2, window^2) int64: the table row of the bias between two
    tokens of a window, by their offset (MONAI's relative_position_index)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


def region_labels(hp: int, wp: int, ws: tuple, ss: tuple) -> torch.Tensor:
    """(hp, wp) float32 region of each cell of the padded grid that
    compute_mask cuts by the slices (0, -window), (-window, -shift),
    (-shift, None) of each axis, a later slice overwriting an earlier one."""
    img = torch.zeros((hp, wp))
    cnt = 0
    for hs in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for wsl in (slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)):
            img[hs, wsl] = cnt
            cnt += 1
    return img


@dataclasses.dataclass
class Grid:
    """One stage's windows on an h x w grid: the window (wh, ww) of T
    tokens, the nw windows of the grid padded to the window, the table rows `rel`
    (T * T,) of the bias, the shifted block's mask (nw, T, T) (None where
    the shift is 0), and per block kind (False: plain, True: shifted) the
    gather `into` the windows ((T * nw,) rows of the grid, h * w for a pad
    token: a zero row appended) and `back` ((h * w,) rows of the windows).
    Windowed tokens lie token-major: row i * nw + window."""

    ws: tuple
    nw: int
    rel: torch.Tensor
    mask: torch.Tensor | None
    into: dict
    back: dict


def make_grid(h: int, w: int, window: int, device) -> Grid:
    ws, ss = window_geometry(h, w, window)
    hp, wp = -(-h // ws[0]) * ws[0], -(-w // ws[1]) * ws[1]
    nwy, nwx = hp // ws[0], wp // ws[1]
    t = ws[0] * ws[1]
    # MONAI takes the first T rows and columns of the configured window's
    # index, also where the window was clipped to a shorter grid
    rel = relative_position_index(window)[:t, :t].reshape(-1)
    shifted = any(s > 0 for s in ss)
    mask = None
    if shifted:
        labels = region_labels(hp, wp, ws, ss).view(nwy, ws[0], nwx, ws[1])
        labels = labels.permute(0, 2, 1, 3).reshape(nwy * nwx, t)
        mask = torch.where(labels[:, None, :] != labels[:, :, None], MASKED, 0.0)
    # windowed token (i = r * ww + c, window = wy * nwx + wx) at the rolled
    # padded position (wy * wh + r, wx * ww + c), taken from the padded
    # position `shift` further on (the roll by -shift)
    r = torch.arange(ws[0]).view(ws[0], 1, 1, 1)
    c = torch.arange(ws[1]).view(1, ws[1], 1, 1)
    wy = torch.arange(nwy).view(1, 1, nwy, 1)
    wx = torch.arange(nwx).view(1, 1, 1, nwx)
    into, back = {}, {}
    for kind in (False, True):
        sh, sw = ss if kind else (0, 0)
        py = (wy * ws[0] + r + sh) % hp
        px = (wx * ws[1] + c + sw) % wp
        src = torch.where((py < h) & (px < w), py * w + px, h * w)
        into[kind] = src.reshape(-1).to(device)
        flat = torch.arange(t * nwy * nwx).view(ws[0], ws[1], nwy, nwx)
        grid = torch.empty(hp, wp, dtype=torch.int64)
        grid[py.expand_as(flat), px.expand_as(flat)] = flat
        back[kind] = grid[:h, :w].reshape(-1).to(device)
    return Grid(ws, nwy * nwx, rel.to(device),
                None if mask is None else mask.to(device), into, back)


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)


class _SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _Mlp(dim, mlp_ratio * dim)


class _Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class _Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: int):
        super().__init__()
        self.blocks = nn.ModuleList(_SwinBlock(dim, heads, window, mlp_ratio)
                                    for _ in range(depth))
        self.downsample = _Merge(dim)


class _InstanceNorm(nn.Module):
    """InstanceNorm (no affine, eps 1e-5) as GroupNorm(C, C) with weight 1 and
    bias 0: buffers outside the state_dict, which MONAI's has none of."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels), persistent=False)
        self.register_buffer("bias", torch.zeros(channels), persistent=False)


class _ResBlock(nn.Module):
    """MONAI's UnetResBlock (kernel 3, stride 1)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.norm1, self.norm2 = _InstanceNorm(cout), _InstanceNorm(cout)
        if cin != cout:
            self.conv3 = nn.Conv2d(cin, cout, 1, bias=False)
            self.norm3 = _InstanceNorm(cout)


class _UpBlock(nn.Module):
    """MONAI's UnetrUpBlock (upsample kernel 2, residual block)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = nn.ConvTranspose2d(cin, cout, 2, 2, bias=False)
        self.conv_block = _ResBlock(2 * cout, cout)


class SwinUNETR(nn.Module):
    """The Swin encoder, the CNN encoder and decoder (module docstring).
    device: where the parameters live, the card unless "cpu" is asked for.
    generator: a torch.Generator for a seeded initialisation (U(+-1/
    sqrt(fan_in)) for conv, transposed conv and linear weights and biases,
    fan_in the terms of each output; the relative-position tables N(0, 0.02),
    the published trunc_normal_(std=.02) without the cut; LayerNorms ones and
    zeros)."""

    def __init__(self, cfg: SwinUNETRConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        c = [cfg.feature_size << s for s in range(5)]
        self.patch_embed = nn.Conv2d(cfg.input_channels, c[0], 2, 2)
        self.layers = nn.ModuleList(_Stage(c[s], d, h, cfg.window, cfg.mlp_ratio)
                                    for s, (d, h) in enumerate(zip(cfg.depths, cfg.heads)))
        self.encoder1 = _ResBlock(cfg.input_channels, c[0])
        self.encoder2 = _ResBlock(c[0], c[0])
        self.encoder3 = _ResBlock(c[1], c[1])
        self.encoder4 = _ResBlock(c[2], c[2])
        self.encoder10 = _ResBlock(c[4], c[4])
        self.decoder5 = _UpBlock(c[4], c[3])
        self.decoder4 = _UpBlock(c[3], c[2])
        self.decoder3 = _UpBlock(c[2], c[1])
        self.decoder2 = _UpBlock(c[1], c[0])
        self.decoder1 = _UpBlock(c[0], c[0])
        self.out = nn.Conv2d(c[0], cfg.output_channels, 1)
        self.grids = {}  # Grid by (h, w, device), built at the first forward of a size
        if generator is not None:
            self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation (class docstring), drawn on the CPU."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                fan = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w[0].numel()
                bound = 1.0 / math.sqrt(fan)
                w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=generator))
                if mod.bias is not None:
                    mod.bias.copy_(torch.empty(mod.bias.shape).uniform_(-bound, bound,
                                                                        generator=generator))
            elif isinstance(mod, nn.LayerNorm):
                mod.reset_parameters()
            elif isinstance(mod, _WindowAttention):
                t = mod.relative_position_bias_table
                t.copy_(torch.empty(t.shape).normal_(0.0, 0.02, generator=generator))

    def num_mask_sites(self) -> int:
        """Rows `site_keys` needs: IN1 of the 10 residual blocks and the 5
        decoder concatenations."""
        return 15

    def geometry(self, h: int, w: int, device) -> Grid:
        key = (h, w, str(device))
        if key not in self.grids:
            self.grids[key] = make_grid(h, w, self.cfg.window, device)
        return self.grids[key]

    def forward(self, x, drop_prob=None, site_keys=None, train: bool = False, mesh=None):
        """x: NHWC float batch -> (N, H, W, output_channels) float32 in [0, 1].
        As UNet.forward: train takes the mask producer at the sites; drop_prob
        None switches DropBlock off."""
        return _Pass(self, drop_prob, site_keys, train, mesh).run(x)


class _Pass(SitePass):
    """One forward pass of Swin UNETR on the shared site machinery."""

    kernel_statistics = True

    def __init__(self, model: SwinUNETR, drop_prob, site_keys, train: bool, mesh):
        cfg = model.cfg
        super().__init__(model, cfg.dropblock, cfg.dtype, drop_prob, site_keys, train, mesh,
                         cfg.remat, "leaky_relu", 0.01)
        self.cfg = cfg
        self.stream = torch.promote_types(cfg.dtype, torch.float32)  # the Swin's residual stream

    @staticmethod
    def inorm(mod) -> Norm:
        return Norm("group", mod, mod.weight.shape[0], IN_EPS)

    def conv(self, x, mod):
        bias = None if mod.bias is None else mod.bias.to(self.dtype)
        y = F.conv2d(_nchw(x.to(self.dtype)), mod.weight.to(self.dtype), bias,
                     stride=mod.stride, padding=mod.padding)
        return _nhwc(y).contiguous()

    def linear(self, x, mod):
        bias = None if mod.bias is None else mod.bias.to(self.dtype)
        return F.linear(x, mod.weight.to(self.dtype), bias)

    # -- the Swin transformer ----------------------------------------------------

    def attention(self, a, attn: _WindowAttention, grid: Grid, shifted: bool):
        """WA of the normed grid a (N, h, w, C) in the pass's dtype -> (N, h,
        w, C): the gather into the windows (pad, roll, partition), the
        projections and SDPA with the bias, the gather back (reverse, roll
        back, crop)."""
        n, h, w, c = a.shape
        heads, t, nw = attn.heads, grid.ws[0] * grid.ws[1], grid.nw
        d = c // heads
        rows = F.pad(a.reshape(n, h * w, c), (0, 0, 0, 1))  # the pad tokens' zero row
        win = rows.index_select(1, grid.into[shifted])
        # qkv's output channels as (heads, 3, d): the windows and heads of a
        # token then merge into one SDPA head dimension of stride 3d
        wq = attn.qkv.weight.view(3, heads, d, c).transpose(0, 1).reshape(3 * c, c)
        bq = attn.qkv.bias.view(3, heads, d).transpose(0, 1).reshape(3 * c)
        qkv = F.linear(win, wq.to(self.dtype), bq.to(self.dtype))
        qkv = qkv.view(n, t, nw * heads, 3, d).transpose(1, 2)
        o = attention(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :],
                      self.bias(attn, grid, shifted))
        o = self.linear(o.transpose(1, 2).reshape(n, t * nw, c), attn.proj)
        return o.index_select(1, grid.back[shifted]).view(n, h, w, c)

    def bias(self, attn: _WindowAttention, grid: Grid, shifted: bool):
        """(1, nw * heads, T, T) additive bias in the pass's dtype: the
        gathered table (+ the mask in a shifted block), its rows padded to
        a multiple of 8 elements in storage, as the memory-efficient kernel
        reads them without a copy."""
        heads, t, nw = attn.heads, grid.ws[0] * grid.ws[1], grid.nw
        rel = attn.relative_position_bias_table[grid.rel].view(t, t, heads).permute(2, 0, 1)
        full = rel[None] if not shifted or grid.mask is None else rel[None] + grid.mask[:, None]
        buf = rel.new_empty((nw, heads, t, -(-t // 8) * 8), dtype=self.dtype)
        buf[..., :t] = full
        return buf[..., :t].reshape(1, nw * heads, t, t)

    def swin_block(self, x, blk: _SwinBlock, grid: Grid, shifted: bool):
        c = x.shape[-1]
        a = F.layer_norm(x, (c,), blk.norm1.weight, blk.norm1.bias, LN_EPS).to(self.dtype)
        x = x + self.attention(a, blk.attn, grid, shifted and grid.mask is not None)
        a = F.layer_norm(x, (c,), blk.norm2.weight, blk.norm2.bias, LN_EPS).to(self.dtype)
        return x + self.linear(F.gelu(self.linear(a, blk.mlp.linear1)), blk.mlp.linear2)

    def merge(self, x, mod: _Merge):
        n, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        a = F.layer_norm(x, (4 * c,), mod.norm.weight, mod.norm.bias, LN_EPS).to(self.dtype)
        return self.linear(a, mod.reduction).to(self.stream)

    def hidden(self, x):
        return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS).to(self.dtype).contiguous()

    def swin(self, x):
        """The padded input (N, H, W, in) -> [x0..x4] (proj_out), NHWC in the
        pass's dtype. The residual stream is float32."""
        m = self.model
        x = self.conv(x, m.patch_embed).to(self.stream)
        out = [self.hidden(x)]
        for stage in m.layers:
            grid = m.geometry(x.shape[1], x.shape[2], x.device)
            for b, blk in enumerate(stage.blocks):  # every second block shifted
                x = self.block(lambda x, blk=blk, g=grid, s=b % 2 == 1:
                               self.swin_block(x, blk, g, s), x)
            x = self.merge(x, stage.downsample)
            out.append(self.hidden(x))
        return out

    # -- the CNN -----------------------------------------------------------------

    def res_block(self, x, blk: _ResBlock):
        (key,) = self.take(1)

        def run(x):
            # no rescale: only IN2, through lrelu and conv2, reads the site
            y = self.site_norm_db_act(self.conv(x, blk.conv1), key, self.inorm(blk.norm1), "skip")
            y = self.site_norm_act(self.conv(y, blk.conv2), self.inorm(blk.norm2), act=False)
            r = x
            if hasattr(blk, "conv3"):
                r = self.site_norm_act(self.conv(x, blk.conv3), self.inorm(blk.norm3), act=False)
            return self.act(y + r)

        return self.block(run, x)

    def up_block(self, x, skip, blk: _UpBlock):
        wt = blk.transp_conv.weight.to(self.dtype)
        u = _nhwc(F.conv_transpose2d(_nchw(x), wt, stride=2))
        # no rescale: conv1 and conv3 read the site, each into an InstanceNorm
        x = self.dropblock(torch.cat([u, skip], -1), self.take(1)[0], "skip")
        return self.res_block(x, blk.conv_block)

    def run(self, x):
        m = self.model
        x = x.to(device=m.out.weight.device, dtype=self.dtype)
        self.sample_offset = rank_offset(self.mesh, x.shape[0])
        x, orig_hw = pad_to_multiple(x, MULTIPLE)
        x = x.contiguous()
        with span("model.swin"):
            hidden = self.swin(x)
        with span("model.encoder"):
            skips = [self.res_block(x, m.encoder1), self.res_block(hidden[0], m.encoder2),
                     self.res_block(hidden[1], m.encoder3), self.res_block(hidden[2], m.encoder4)]
            x = self.res_block(hidden[4], m.encoder10)
        with span("model.decoder"):
            for blk, skip in zip((m.decoder5, m.decoder4, m.decoder3, m.decoder2, m.decoder1),
                                 (hidden[3], *skips[::-1])):
                x = self.up_block(x, skip, blk)
        # the logit in float32 from the bf16 activations
        x = torch.sigmoid(_nhwc(F.conv2d(_nchw(x).to(self.stream), m.out.weight, m.out.bias)))
        x = crop_to(x, orig_hw)
        self.recomputing = True  # what runs from here on is a remat re-run
        return torch.nan_to_num(torch.clamp(x, 0.0, 1.0), nan=0.0)
