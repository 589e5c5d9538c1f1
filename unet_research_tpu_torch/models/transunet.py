"""TransUNet R50-ViT-B/16 (Chen et al. 2021, arXiv:2102.04306) as an nn.Module,
with the study's DropBlock plug-in.

Built as the official code builds it (github.com/Beckschen/TransUNet,
networks/vit_seg_configs.py::get_r50_b16_config, vit_seg_modeling.py,
vit_seg_modeling_resnet_skip.py), at its published widths:

- input: a 1-channel frame is repeated to 3 channels; the canvas is
  zero-padded at the bottom and right to a multiple of 16 and the output
  cropped back (the U-Net's autopad);
- root: StdConv 7x7 stride 2 (3 -> width) -> GroupNorm(32, eps 1e-6) ->
  ReLU -> max-pool 3 stride 2; the root's output is skip 3;
- body: three stages of (3, 4, 9) bottleneck units, outputs 4, 8, 16 x
  width, mid widths 1, 2, 4 x width, stride 2 on the 3x3 conv of the first
  unit of stages 2 and 3: y = relu(gn1(conv1(x))), y = relu(gn2(conv2(y))),
  y = gn3(conv3(y)), out = relu(y + r), r = x or gn_proj(downsample(x)) in
  a stage's first unit. Every conv is a bias-free StdConv (each output
  filter standardised: biased variance over (in, kh, kw), eps 1e-5);
  gn1-3 are GroupNorm(32, eps 1e-6), gn_proj GroupNorm(C, C) (one channel
  a group, eps 1e-5). Stages 1 and 2 give skips 2 and 1, each zero-padded
  at its bottom and right to the canvas / 4 and / 8 where the pool's floor
  left it short (by the decoder's merge). (The official code assumes a
  square input and pads both sides to one size; this pads each dimension to
  its own.)
- embedding: a 1x1 conv 16 x width -> hidden with bias, plus one learned
  position per cell of the token grid (`grid`; published 14 x 14 = 196 for
  224^2, here 37 x 36 = 1332 for DRIVE's 592 x 576 canvas; another grid
  interpolates the table bilinearly), dropout;
- transformer: `layers` pre-LN blocks, x = x + proj(MHSA(LN(x))) with
  `heads` heads and QKV and out projections with bias, x = x +
  drop(fc2(drop(GELU(fc1(LN(x)))))); LayerNorm eps 1e-6, a final
  LayerNorm;
- decoder: the tokens as a grid -> 3x3 conv hidden -> head_channels
  (BatchNorm, ReLU), then per block bilinear x2 upsampling (align_corners,
  as UpsamplingBilinear2d), the skip concatenated (none after n_skip) and
  two (3x3 conv, no bias -> BatchNorm -> ReLU); a 3x3 head with bias and a
  sigmoid. One output for the study's vessel map and its masked BCE (the
  published model has Synapse's 9 softmax classes).

The study's plug-in is dependent (or independent) DropBlock with the U-Net's
per-site gamma and counter-hash masks (models/sites.py) at 45 sites in
call order: norm -> mask -> ReLU at the root, at gn1 and gn2 of every unit,
at conv_more and at the 8 decoder convs, and one bare site at each skip
merge. Each site rescales by its own sample's keep count, but the sites at
gn1 and gn2, whose output reaches only the scale-invariant GroupNorm after
the next bias-free conv, leave it out (GN(conv(s x)) = GN(conv(x)) for a
per-sample s > 0, up to the eps: the U-Net's fold_rescale). Ensemble
members vary only through the mask sites. The transformer's dropout acts in training only and draws by the
same counter hash, keyed by site 0's words XOR a tag per dropout site
(`dropout_tags`), so a remat re-run and a captured step draw the same
masks, with no generator state.

`forward(x, drop_prob=None, site_keys=None, train=False, mesh=None)` is the
U-Net's contract (models/unet.py): NHWC in and out, float32 parameters and
`cfg.dtype` at use, `cfg.remat` honoured (the root, each unit, each
transformer block, conv_more and each decoder block). On the card the
routes are:

- GroupNorm + ReLU mask sites and BatchNorm (eval) + ReLU ones take K1 in
  eval with DropBlock on (the GroupNorm coefficients from `gn_stats` and
  `gn_stats_finish`, BatchNorm's from its running statistics), the mask
  producer K2 and GroupNorm's epilogue kernels in training; an eval
  BatchNorm off K1 takes `gn_apply`, a train-mode one the plain ops
  (counted in `bn:plain`);
- gn3 and gn_proj take `group_norm_act` with no activation (or the plain
  ops, counted in `gn:plain`);
- attention is SDPA held to the flash backend (ops/attention.py), counted
  in `attn:flash` / `attn:other`;
- each decoder block's bilinear x2 upsampling, skip concatenation and the
  skip's pad are one kernel (ops/cuda/upsample.py), counted in `up:kernel`
  (or the plain ops, counted in `up:plain`);
- the convs and projections are cuDNN's and cuBLAS's, the head's in float32
  (the logit, from the bf16 activations). A StdConv's standardisation runs
  in each forward (in float32, then cast), so a captured forward reads the
  weights as they are at each replay.

The spans `model.encoder`, `model.vit` and `model.decoder` (spans.py) mark
an eager forward's parts; a replayed graph records none.
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
from unet_research_tpu_torch.ops.cuda.upsample import upsample_merge
from unet_research_tpu_torch.ops.dropblock import hash_bits
from unet_research_tpu_torch.ops.image import crop_to, pad_to_multiple
from unet_research_tpu_torch.parallel.mesh import rank_offset
from unet_research_tpu_torch.spans import span

GN_EPS, LN_EPS, STD_EPS = 1e-6, 1e-6, 1e-5
# the per-site tags that key the transformer's dropout (module docstring)
TAG0, TAG1 = 0x9E3779B9, 0x85EBCA6B


@dataclasses.dataclass(frozen=True)
class TransUNetConfig:
    """The model's widths and depths, by default R50-ViT-B/16's published
    ones (get_r50_b16_config) on DRIVE's 592 x 576 canvas with one output,
    the DropBlock plug-in and the routes. width: the ResNet root's (stages 4x,
    8x, 16x it); units: bottleneck units per stage; hidden, layers, heads,
    mlp: the ViT's; head_channels: conv_more's output; decoder: the four
    blocks' outputs; n_skip: the skips the decoder takes (at most 3); grid:
    the token grid the position table holds (canvas / 16)."""

    output_channels: int = 1
    width: int = 64
    units: tuple = (3, 4, 9)
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp: int = 3072
    head_channels: int = 512
    decoder: tuple = (256, 128, 64, 16)
    n_skip: int = 3
    grid: tuple = (37, 36)
    gn_groups: int = 32
    dropout: float = 0.1
    dropblock: DropBlockConfig = dataclasses.field(default_factory=DropBlockConfig)
    remat: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.units) != 3 or len(self.decoder) != 4:
            raise ValueError("TransUNet has three encoder stages and four decoder blocks")
        if not 0 <= self.n_skip <= 3:
            raise ValueError("n_skip must be 0..3")
        if self.hidden % self.heads:
            raise ValueError("hidden must divide into heads")
        if self.width % self.gn_groups:
            raise ValueError("width must be a multiple of gn_groups")
        if self.dropblock.kind not in (None, "dependent", "independent"):
            raise ValueError("dropblock.kind must be dependent/independent/None")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("dropout must be in [0, 1)")


def skip_channels(cfg: TransUNetConfig) -> list:
    """The channels of the skip each decoder block concatenates (0: none)."""
    chans = [8 * cfg.width, 4 * cfg.width, cfg.width, 0]
    return [c if i < cfg.n_skip else 0 for i, c in enumerate(chans)]


class _Unit(nn.Module):
    """One bottleneck unit (PreActBottleneck of vit_seg_modeling_resnet_skip.py,
    which runs its norms after the convs)."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int, groups: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cmid, 1, bias=False)
        self.gn1 = nn.GroupNorm(groups, cmid, eps=GN_EPS)
        self.conv2 = nn.Conv2d(cmid, cmid, 3, stride, 1, bias=False)
        self.gn2 = nn.GroupNorm(groups, cmid, eps=GN_EPS)
        self.conv3 = nn.Conv2d(cmid, cout, 1, bias=False)
        self.gn3 = nn.GroupNorm(groups, cout, eps=GN_EPS)
        if stride != 1 or cin != cout:
            self.downsample = nn.Conv2d(cin, cout, 1, stride, bias=False)
            self.gn_proj = nn.GroupNorm(cout, cout)


class _Layer(nn.Module):
    """One pre-LN transformer block."""

    def __init__(self, hidden: int, mlp: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.fc1 = nn.Linear(hidden, mlp)
        self.fc2 = nn.Linear(mlp, hidden)


class _DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)


class TransUNet(nn.Module):
    """The hybrid encoder, the ViT and the cascaded upsampler (module
    docstring). device: where the parameters live, the card unless "cpu" is
    asked for. generator: a torch.Generator for a seeded torch-style
    initialisation (U(+-1/sqrt(fan_in)) for conv and linear weights and
    biases, positions N(0, 0.02), norms ones and zeros)."""

    def __init__(self, cfg: TransUNetConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        w, g = cfg.width, cfg.gn_groups
        self.root = nn.ModuleDict({"conv": nn.Conv2d(3, w, 7, 2, 3, bias=False),
                                   "gn": nn.GroupNorm(g, w, eps=GN_EPS)})
        self.body = nn.ModuleList()
        cin = w
        for s, count in enumerate(cfg.units):
            cout, cmid = 4 * w << s, w << s
            self.body.append(nn.ModuleList(
                _Unit(cin if u == 0 else cout, cout, cmid, 2 if (u == 0 and s > 0) else 1, g)
                for u in range(count)))
            cin = cout
        gh, gw = cfg.grid
        self.patch = nn.Conv2d(cin, cfg.hidden, 1)
        self.pos = nn.Parameter(torch.zeros(1, gh * gw, cfg.hidden))
        self.vit = nn.ModuleList(_Layer(cfg.hidden, cfg.mlp) for _ in range(cfg.layers))
        self.vit_norm = nn.LayerNorm(cfg.hidden, eps=LN_EPS)
        self.conv_more = nn.ModuleDict({
            "conv": nn.Conv2d(cfg.hidden, cfg.head_channels, 3, padding=1, bias=False),
            "bn": nn.BatchNorm2d(cfg.head_channels)})
        ins = [cfg.head_channels, *cfg.decoder[:-1]]
        self.decoder = nn.ModuleList(_DecoderBlock(i + s, o) for i, s, o in
                                     zip(ins, skip_channels(cfg), cfg.decoder))
        self.head = nn.Conv2d(cfg.decoder[-1], cfg.output_channels, 3, padding=1)
        tags = [[((j + 1) * TAG0) & 0xFFFFFFFF, ((j + 1) * TAG1) & 0xFFFFFFFF]
                for j in range(1 + 2 * cfg.layers)]
        self.register_buffer("dropout_tags", torch.tensor(tags, dtype=torch.int64),
                             persistent=False)
        if generator is not None:
            self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded torch-style initialisation, drawn on the CPU."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.copy_(torch.empty(mod.weight.shape).uniform_(-bound, bound,
                                                                        generator=generator))
                if mod.bias is not None:
                    mod.bias.copy_(torch.empty(mod.bias.shape).uniform_(-bound, bound,
                                                                        generator=generator))
            elif isinstance(mod, (nn.GroupNorm, nn.BatchNorm2d, nn.LayerNorm)):
                mod.reset_parameters()
        self.pos.copy_(torch.empty(self.pos.shape).normal_(0.0, 0.02, generator=generator))

    def num_mask_sites(self) -> int:
        """Rows `site_keys` needs: the root, two per unit, conv_more, two per
        decoder block and one per skip merge."""
        cfg = self.cfg
        return 2 + 2 * sum(cfg.units) + 2 * len(cfg.decoder) + cfg.n_skip

    def forward(self, x, drop_prob=None, site_keys=None, train: bool = False, mesh=None):
        """x: NHWC float batch -> (N, H, W, output_channels) float32 in [0, 1].
        As UNet.forward: train runs BatchNorm on batch statistics (updating
        the running ones), the mask producer at the sites and the
        transformer's dropout; drop_prob None switches DropBlock off."""
        return _Pass(self, drop_prob, site_keys, train, mesh).run(x)


class _Pass(SitePass):
    """One forward pass of TransUNet on the shared site machinery."""

    kernel_statistics = True

    def __init__(self, model: TransUNet, drop_prob, site_keys, train: bool, mesh):
        cfg = model.cfg
        super().__init__(model, cfg.dropblock, cfg.dtype, drop_prob, site_keys, train, mesh,
                         cfg.remat, "relu", 0.01)
        self.cfg = cfg
        self.drops = 0  # dropout sites handed out so far

    @staticmethod
    def gn(mod) -> Norm:
        return Norm("group", mod, mod.num_groups, mod.eps)

    @staticmethod
    def bn(mod) -> Norm:
        return Norm("batch", mod, 1, mod.eps)

    # -- layers ----------------------------------------------------------------

    def conv(self, x, mod, std: bool = True):
        """A conv of NHWC x; std: a StdConv (its weight standardised per
        output filter in float32 first)."""
        wt = mod.weight
        if std:
            wt = F.layer_norm(wt.reshape(wt.shape[0], -1), (wt[0].numel(),),
                              eps=STD_EPS).reshape(wt.shape)
        bias = None if mod.bias is None else mod.bias.to(self.dtype)
        y = F.conv2d(_nchw(x.to(self.dtype)), wt.to(self.dtype), bias, stride=mod.stride,
                     padding=mod.padding)
        return _nhwc(y).contiguous()

    def linear(self, x, mod):
        return F.linear(x, mod.weight.to(self.dtype), mod.bias.to(self.dtype))

    def drop_keys(self, count: int) -> list:
        """The next `count` dropout sites' key words, or None each where the
        dropout is off (eval, no site keys or a rate of 0)."""
        if not (self.train and self.active and self.cfg.dropout > 0):
            return [None] * count
        tags = self.model.dropout_tags[self.drops:self.drops + count]
        self.drops += count
        return list(self.site_keys[0] ^ tags)

    def dropout(self, x, key):
        """x with each element kept where the counter hash's 24 bits reach
        ceil(rate * 2^24), scaled by 1 / (1 - rate)."""
        if key is None:
            return x
        rate = self.cfg.dropout
        keep = hash_bits(key, tuple(x.shape), self.sample_offset) >= math.ceil(rate * (1 << 24))
        return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))

    # -- parts -----------------------------------------------------------------

    def unit(self, x, u: _Unit):
        keys = self.take(2)

        def run(x):
            r = x
            if hasattr(u, "downsample"):
                r = self.site_norm_act(self.conv(x, u.downsample), self.gn(u.gn_proj),
                                       act=False)
            # no rescale: only the next GroupNorm reads these sites (module docstring)
            y = self.site_norm_db_act(self.conv(x, u.conv1), keys[0], self.gn(u.gn1), "skip")
            y = self.site_norm_db_act(self.conv(y, u.conv2), keys[1], self.gn(u.gn2), "skip")
            y = self.site_norm_act(self.conv(y, u.conv3), self.gn(u.gn3), act=False)
            return torch.relu(y + r)

        return self.block(run, x)

    def encoder(self, x):
        """(stage 3's output, [skip 1, skip 2, skip 3]) of the padded input,
        each skip at its own size."""
        m = self.model
        (key,) = self.take(1)
        h0, w0 = x.shape[1:3]
        x = self.block(lambda x: self.site_norm_db_act(
            self.conv(x, m.root["conv"]), key, self.gn(m.root["gn"]), "sample"), x)
        feats = [x]
        x = _nhwc(F.max_pool2d(_nchw(x), 3, 2)).contiguous()
        for s, stage in enumerate(m.body):
            for u in stage:
                x = self.unit(x, u)
            if s < len(m.body) - 1:
                hh, ww = h0 // (4 << s), w0 // (4 << s)
                if x.shape[1] > hh or x.shape[2] > ww:
                    raise ValueError(f"stage {s + 1} gives {tuple(x.shape[1:3])}, past "
                                     f"the skip's {(hh, ww)}")
                feats.append(x)  # the decoder's merge pads it to (hh, ww)
        return x, feats[::-1]

    def positions(self, gh: int, gw: int):
        """The position table at a gh x gw token grid (the configured grid's
        own, or bilinearly interpolated to another)."""
        pos, (ch, cw) = self.model.pos, self.cfg.grid
        if (gh, gw) == (ch, cw):
            return pos
        grid = pos.reshape(1, ch, cw, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
        return grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)

    def layer(self, h, lay: _Layer, keys):
        cfg = self.cfg
        n, t, d = h.shape
        a = F.layer_norm(h, (d,), lay.ln1.weight, lay.ln1.bias, LN_EPS).to(self.dtype)
        qkv = self.linear(a, lay.qkv).reshape(n, t, 3, cfg.heads, d // cfg.heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        o = attention(qkv[0], qkv[1], qkv[2]).transpose(1, 2).reshape(n, t, d)
        h = h + self.linear(o, lay.proj)
        a = F.layer_norm(h, (d,), lay.ln2.weight, lay.ln2.bias, LN_EPS).to(self.dtype)
        a = self.dropout(F.gelu(self.linear(a, lay.fc1)), keys[0])
        return h + self.dropout(self.linear(a, lay.fc2), keys[1])

    def vit(self, x):
        """Stage 3's output (N, gh, gw, C) -> the encoded tokens as a grid
        (N, gh, gw, hidden) in the pass's dtype. The residual stream is
        float32."""
        m = self.model
        n, gh, gw, c = x.shape
        tokens = F.linear(x.reshape(n, gh * gw, c),
                          m.patch.weight.reshape(-1, c).to(self.dtype), m.patch.bias.to(self.dtype))
        h = self.dropout(tokens.to(torch.float32) + self.positions(gh, gw),
                         self.drop_keys(1)[0])
        for lay in m.vit:
            keys = self.drop_keys(2)
            h = self.block(lambda h, lay=lay, keys=keys: self.layer(h, lay, keys), h)
        h = F.layer_norm(h, (h.shape[-1],), m.vit_norm.weight, m.vit_norm.bias, LN_EPS)
        return h.to(self.dtype).reshape(n, gh, gw, -1)

    def decoder(self, x, feats):
        m = self.model
        (key,) = self.take(1)
        x = self.block(lambda x: self.site_norm_db_act(
            self.conv(x, m.conv_more["conv"], std=False), key, self.bn(m.conv_more["bn"]),
            "sample"), x)
        for i, blk in enumerate(m.decoder):
            skip = feats[i] if skip_channels(self.cfg)[i] else None
            x = upsample_merge(x, skip)
            if skip is not None:
                x = self.dropblock(x, self.take(1)[0], "sample")
            keys = self.take(2)

            def run(x, blk=blk, keys=keys):
                x = self.site_norm_db_act(self.conv(x, blk.conv1, std=False), keys[0],
                                          self.bn(blk.bn1), "sample")
                return self.site_norm_db_act(self.conv(x, blk.conv2, std=False), keys[1],
                                             self.bn(blk.bn2), "sample")

            x = self.block(run, x)
        return x

    def run(self, x):
        device = self.model.head.weight.device
        x = x.to(device=device, dtype=self.dtype)
        self.sample_offset = rank_offset(self.mesh, x.shape[0])
        x, orig_hw = pad_to_multiple(x, 16)
        if x.shape[-1] == 1:
            x = x.expand(-1, -1, -1, 3)
        x = x.contiguous()
        with span("model.encoder"):
            x, feats = self.encoder(x)
        with span("model.vit"):
            x = self.vit(x)
        with span("model.decoder"):
            x = self.decoder(x, feats)
        # the logit in float32 from the bf16 activations: its rounding to bf16 was
        # a third of a bf16 ensemble's std gap from float32
        head = self.model.head
        x = torch.sigmoid(_nhwc(F.conv2d(_nchw(x).float(), head.weight, head.bias,
                                         padding=head.padding)))
        x = crop_to(x, orig_hw)
        self.recomputing = True  # what runs from here on is a remat re-run
        return torch.nan_to_num(torch.clamp(x, 0.0, 1.0), nan=0.0)
