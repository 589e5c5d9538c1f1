"""The plain reference of TransUNet R50-ViT-B/16 with the study's DropBlock, in
float32 PyTorch with TF32 off; it imports neither JAX nor the port.

Written from the published description (Chen et al. 2021, arXiv:2102.04306)
and the official code (github.com/Beckschen/TransUNet: networks/
vit_seg_configs.py::get_r50_b16_config, vit_seg_modeling.py,
vit_seg_modeling_resnet_skip.py), one layer at a time, NCHW, with no kernel
and no batching of its own. A configuration is a dict (the benchmark's
configuration file): width, units, hidden, layers, heads, mlp,
head_channels, decoder, n_skip, grid, gn_groups, dropout, output_channels,
and dropblock {kind, block_size}.

Parameters are a mapping from the port's state-dict names to float32
tensors (`param_specs` lists them, with how the benchmark seeds each).
`Drop` draws the DropBlock masks by the counter hash of the benchmark's
U-Net reference (benchmark/reference/unet.py::Drop, the same function, a
copy); the transformer's dropout draws by the same hash (`dropout_keys`).
`quant` (the control) keeps every layer's output and every weight in
float8 (e4m3).

Departures from the published model, each at its line: one output with a
sigmoid (the study's vessel map) for Synapse's 9 softmax classes; the
position table sized to the configured token grid (37 x 36 for DRIVE's
592 x 576 canvas, 14 x 14 published), bilinearly interpolated to any other;
the skips zero-padded per dimension (the official code assumes a square
input); the DropBlock plug-in at 45 sites.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

GN_EPS, LN_EPS, STD_EPS, BN_EPS, PROJ_EPS = 1e-6, 1e-6, 1e-5, 1e-5, 1e-5
TAG0, TAG1 = 0x9E3779B9, 0x85EBCA6B  # the dropout sites' key tags
M32 = 0xFFFFFFFF


# --- the configuration's shapes ----------------------------------------------------

def stages(cfg: dict) -> list:
    """[(c_in, c_out, c_mid, units, first stride)] of the three stages."""
    w, out, cin = cfg["width"], [], cfg["width"]
    for s, count in enumerate(cfg["units"]):
        out.append((cin, 4 * w << s, w << s, count, 1 if s == 0 else 2))
        cin = 4 * w << s
    return out


def skip_channels(cfg: dict) -> list:
    chans = [8 * cfg["width"], 4 * cfg["width"], cfg["width"], 0]
    return [c if i < cfg["n_skip"] else 0 for i, c in enumerate(chans)]


def param_specs(cfg: dict) -> list:
    """[(name, shape, init, fan_in)] in state-dict order. init: 'uniform'
    (U(+-1/sqrt(fan_in)): conv and linear weights and biases), 'one',
    'zero' (norms' weights and biases), 'pos' (N(0, 0.02)), 'mean'
    (U(-0.1, 0.1)) and 'var' (U(0.5, 1.5)) (BatchNorm's running
    statistics), 'count' (its num_batches_tracked, int64 0)."""
    specs = []

    def conv(name, cout, cin, k, bias=False):
        specs.append((f"{name}.weight", (cout, cin, k, k), "uniform", cin * k * k))
        if bias:
            specs.append((f"{name}.bias", (cout,), "uniform", cin * k * k))

    def linear(name, cout, cin):
        specs.append((f"{name}.weight", (cout, cin), "uniform", cin))
        specs.append((f"{name}.bias", (cout,), "uniform", cin))

    def norm(name, c):
        specs.extend([(f"{name}.weight", (c,), "one", 0), (f"{name}.bias", (c,), "zero", 0)])

    def bn(name, c):
        norm(name, c)
        specs.extend([(f"{name}.running_mean", (c,), "mean", 0),
                      (f"{name}.running_var", (c,), "var", 0),
                      (f"{name}.num_batches_tracked", (), "count", 0)])

    w, d = cfg["width"], cfg["hidden"]
    conv("root.conv", w, 3, 7)
    norm("root.gn", w)
    for s, (cin, cout, cmid, count, stride) in enumerate(stages(cfg)):
        for u in range(count):
            pre = f"body.{s}.{u}"
            conv(f"{pre}.conv1", cmid, cin if u == 0 else cout, 1)
            norm(f"{pre}.gn1", cmid)
            conv(f"{pre}.conv2", cmid, cmid, 3)
            norm(f"{pre}.gn2", cmid)
            conv(f"{pre}.conv3", cout, cmid, 1)
            norm(f"{pre}.gn3", cout)
            if u == 0:
                conv(f"{pre}.downsample", cout, cin, 1)
                norm(f"{pre}.gn_proj", cout)
    conv("patch", d, 16 * w, 1, bias=True)
    gh, gw = cfg["grid"]
    specs.append(("pos", (1, gh * gw, d), "pos", 0))
    for i in range(cfg["layers"]):
        norm(f"vit.{i}.ln1", d)
        linear(f"vit.{i}.qkv", 3 * d, d)
        linear(f"vit.{i}.proj", d, d)
        norm(f"vit.{i}.ln2", d)
        linear(f"vit.{i}.fc1", cfg["mlp"], d)
        linear(f"vit.{i}.fc2", d, cfg["mlp"])
    norm("vit_norm", d)
    conv("conv_more.conv", cfg["head_channels"], d, 3)
    bn("conv_more.bn", cfg["head_channels"])
    ins = [cfg["head_channels"], *cfg["decoder"][:-1]]
    for i, (cin, skip, cout) in enumerate(zip(ins, skip_channels(cfg), cfg["decoder"])):
        conv(f"decoder.{i}.conv1", cout, cin + skip, 3)
        bn(f"decoder.{i}.bn1", cout)
        conv(f"decoder.{i}.conv2", cout, cout, 3)
        bn(f"decoder.{i}.bn2", cout)
    conv("head", cfg["output_channels"], cfg["decoder"][-1], 3, bias=True)
    return specs


def num_sites(cfg: dict) -> int:
    """Mask sites: the root, two per unit, conv_more, two per decoder block,
    one per skip merge."""
    return 2 + 2 * sum(cfg["units"]) + 2 * len(cfg["decoder"]) + cfg["n_skip"]


def canvas(h: int, w: int) -> tuple:
    """The padded input: H and W rounded up to a multiple of 16."""
    return -(-h // 16) * 16, -(-w // 16) * 16


def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def mask_sites(cfg: dict, h: int, w: int) -> list:
    """(h, w, c) of every mask site in call order on the padded h x w
    canvas."""
    sites = []
    hh, ww = _conv_out(h, 7, 2, 3), _conv_out(w, 7, 2, 3)
    sites.append((hh, ww, cfg["width"]))
    hh, ww = _conv_out(hh, 3, 2, 0), _conv_out(ww, 3, 2, 0)
    for cin, cout, cmid, count, stride in stages(cfg):
        for u in range(count):
            sites.append((hh, ww, cmid))
            if u == 0 and stride == 2:
                hh, ww = _conv_out(hh, 3, 2, 1), _conv_out(ww, 3, 2, 1)
            sites.append((hh, ww, cmid))
    gh, gw = h // 16, w // 16
    sites.append((gh, gw, cfg["head_channels"]))
    ins = [cfg["head_channels"], *cfg["decoder"][:-1]]
    for i, (cin, skip, cout) in enumerate(zip(ins, skip_channels(cfg), cfg["decoder"])):
        gh, gw = 2 * gh, 2 * gw
        if skip:
            sites.append((gh, gw, cin + skip))
        sites += [(gh, gw, cout)] * 2
    return sites


def model_flops(cfg: dict, h: int, w: int) -> float:
    """2 x the multiply-adds of one forward of one image on the padded h x w
    canvas: every conv (at its output's size), every linear layer, and the
    attention's two products (QK^T and AV, T^2 x hidden each a layer)."""
    macs = 0
    hh, ww = _conv_out(h, 7, 2, 3), _conv_out(w, 7, 2, 3)
    macs += hh * ww * cfg["width"] * 3 * 49
    hh, ww = _conv_out(hh, 3, 2, 0), _conv_out(ww, 3, 2, 0)
    for cin, cout, cmid, count, stride in stages(cfg):
        for u in range(count):
            c_in = cin if u == 0 else cout
            macs += hh * ww * c_in * cmid
            h2, w2 = ((_conv_out(hh, 3, 2, 1), _conv_out(ww, 3, 2, 1))
                      if (u == 0 and stride == 2) else (hh, ww))
            macs += h2 * w2 * cmid * cmid * 9 + h2 * w2 * cmid * cout
            if u == 0:
                macs += h2 * w2 * c_in * cout
            hh, ww = h2, w2
    t, d = (h // 16) * (w // 16), cfg["hidden"]
    macs += t * 16 * cfg["width"] * d
    macs += cfg["layers"] * (t * (4 * d * d + 2 * d * cfg["mlp"]) + 2 * t * t * d)
    gh, gw = h // 16, w // 16
    macs += gh * gw * d * cfg["head_channels"] * 9
    ins = [cfg["head_channels"], *cfg["decoder"][:-1]]
    for cin, skip, cout in zip(ins, skip_channels(cfg), cfg["decoder"]):
        gh, gw = 2 * gh, 2 * gw
        macs += gh * gw * 9 * cout * (cin + skip + cout)
    macs += gh * gw * 9 * cfg["decoder"][-1] * cfg["output_channels"]
    return 2.0 * macs


# --- the counter hash and the DropBlock masks ------------------------------------

def _i32(word: int) -> int:
    """A uint32 word as the int32 with the same bits."""
    word &= M32
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
    np.float32 (float32 arithmetic, as a device word computes it)."""
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
    dropped = F.max_pool2d(seeds * inner, (block, 1), stride=1, padding=(p, 0))
    dropped = F.max_pool2d(dropped, (1, block), stride=1, padding=(0, p))
    return 1.0 - dropped


class Drop:
    """The DropBlock state of one forward: per-site key words (S, 2), the drop
    probability, the block size and the global row of the batch's first
    sample. A site rescales each sample by its own keep count."""

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

    def dropout_keys(self, site: int) -> tuple:
        """The key words of the transformer's dropout site `site`: site 0's
        words XOR the site's tags."""
        k0, k1 = self.keys[0]
        return k0 ^ (((site + 1) * TAG0) & M32), k1 ^ (((site + 1) * TAG1) & M32)


# --- the control's float8 ---------------------------------------------------------

def fake_quant(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` with a per-tensor scale that maps its largest
    magnitude to the format's largest finite value, and back to float32."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Quant(torch.autograd.Function):
    """Forward: fake_quant to float8 e4m3; backward: the cotangent to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return fake_quant(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fake_quant(g, torch.float8_e5m2)


# --- the forward ------------------------------------------------------------------

def forward(params: dict, x: torch.Tensor, cfg: dict, drop: Drop | None = None,
            quant: bool = False, train: bool = False) -> torch.Tensor:
    """x: NHWC float32 (N, H, W, C) -> (N, H, W, 1) float32 in [0, 1].
    drop: the DropBlock state, or None for DropBlock off (and no dropout).
    quant: the control (module docstring). train: BatchNorm on the batch's
    statistics and the transformer's dropout on (with drop's keys)."""
    p = params
    h0, w0 = x.shape[1], x.shape[2]
    site = [0]
    dropped_out = [0]

    def store(t):
        return _Quant.apply(t) if quant else t

    def conv(x, name, std=True, **kw):
        wt = p[f"{name}.weight"]
        if std:  # StdConv2d: each output filter standardised, biased variance
            v, m = torch.var_mean(wt, dim=(1, 2, 3), keepdim=True, unbiased=False)
            wt = (wt - m) / torch.sqrt(v + STD_EPS)
        bias = p.get(f"{name}.bias")
        return store(F.conv2d(x, store(wt), None if bias is None else store(bias), **kw))

    def gn(x, name, groups, eps=GN_EPS):
        return store(F.group_norm(x, groups, p[f"{name}.weight"], p[f"{name}.bias"], eps))

    def bn(x, name):
        return store(F.batch_norm(x, None if train else p[f"{name}.running_mean"],
                                  None if train else p[f"{name}.running_var"],
                                  p[f"{name}.weight"], p[f"{name}.bias"], train, 0.0, BN_EPS))

    def masked(x):
        if drop is not None:
            x = drop(x, site[0])
        site[0] += 1
        return x

    def dropout(x):  # (N, T, D); the counter hash at the flat (n, t, d) index
        j = dropped_out[0]
        dropped_out[0] += 1
        rate = cfg["dropout"]
        if not train or drop is None or rate == 0:
            return x
        k0, k1 = drop.dropout_keys(j)
        keep = hash_bits(k0, k1, x.shape, drop.offset, x.device) >= math.ceil(rate * (1 << 24))
        return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))

    def linear(x, name):
        return store(F.linear(x, store(p[f"{name}.weight"]), store(p[f"{name}.bias"])))

    def ln(x, name):
        return store(F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"],
                                  LN_EPS))

    # canvas: zero-padded at the bottom and right to a multiple of 16
    x = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (0, -w0 % 16, 0, -h0 % 16))
    hc, wc = x.shape[2], x.shape[3]
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)  # a gray frame repeated to RGB, as TransUNet's forward does
    x = store(x)
    # root: StdConv 7x7/2 -> GN -> mask -> ReLU, then max-pool 3/2
    x = store(torch.relu(masked(gn(conv(x, "root.conv", stride=2, padding=3), "root.gn",
                                   cfg["gn_groups"]))))
    feats = [x]
    x = F.max_pool2d(x, 3, 2)
    for s, (cin, cout, cmid, count, stride) in enumerate(stages(cfg)):
        for u in range(count):
            pre = f"body.{s}.{u}"
            st = stride if u == 0 else 1
            r = x
            if u == 0:  # the projection: GroupNorm(C, C), eps 1e-5
                r = gn(conv(x, f"{pre}.downsample", stride=st), f"{pre}.gn_proj", cout, PROJ_EPS)
            y = store(torch.relu(masked(gn(conv(x, f"{pre}.conv1"), f"{pre}.gn1",
                                           cfg["gn_groups"]))))
            y = store(torch.relu(masked(gn(conv(y, f"{pre}.conv2", stride=st, padding=1),
                                           f"{pre}.gn2", cfg["gn_groups"]))))
            y = gn(conv(y, f"{pre}.conv3"), f"{pre}.gn3", cfg["gn_groups"])
            x = store(torch.relu(y + r))
        if s < 2:  # the skip, zero-padded at its bottom and right (per dimension: a departure)
            hh, ww = hc // (4 << s), wc // (4 << s)
            feats.append(F.pad(x, (0, ww - x.shape[3], 0, hh - x.shape[2])))
    feats = feats[::-1]
    # embedding: 1x1 conv with bias, learned positions (the configured grid's), dropout
    n, c, gh, gw = x.shape
    t, d = gh * gw, cfg["hidden"]
    tok = conv(x, "patch", std=False).flatten(2).transpose(1, 2)
    pos = p["pos"]
    if (gh, gw) != tuple(cfg["grid"]):  # another grid: the table interpolated (a departure)
        ch, cw = cfg["grid"]
        grid = pos.reshape(1, ch, cw, d).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
        pos = grid.permute(0, 2, 3, 1).reshape(1, t, d)
    h = dropout(store(tok + store(pos)))
    heads = cfg["heads"]
    for i in range(cfg["layers"]):
        a = ln(h, f"vit.{i}.ln1")
        qkv = linear(a, f"vit.{i}.qkv").reshape(n, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = store(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads), dim=-1))
        o = store(att @ v).transpose(1, 2).reshape(n, t, d)
        h = store(h + linear(o, f"vit.{i}.proj"))
        a = ln(h, f"vit.{i}.ln2")
        a = dropout(store(F.gelu(linear(a, f"vit.{i}.fc1"))))
        h = store(h + dropout(linear(a, f"vit.{i}.fc2")))
    h = ln(h, "vit_norm")
    # decoder: conv_more, then (x2 bilinear, skip, mask, 2 x (conv, BN, mask, ReLU)) x 4
    x = h.transpose(1, 2).reshape(n, d, gh, gw)
    x = store(torch.relu(masked(bn(conv(x, "conv_more.conv", std=False, padding=1),
                                   "conv_more.bn"))))
    for i, skip in enumerate(skip_channels(cfg)):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if skip:
            x = masked(torch.cat([x, feats[i]], dim=1))
        for j in (1, 2):
            x = conv(x, f"decoder.{i}.conv{j}", std=False, padding=1)
            x = store(torch.relu(masked(bn(x, f"decoder.{i}.bn{j}"))))
    # one output and a sigmoid: the study's vessel map (a departure from 9 classes)
    x = torch.sigmoid(conv(x, "head", std=False, padding=1))[:, :, :h0, :w0]
    return torch.nan_to_num(torch.clamp(x, 0.0, 1.0), nan=0.0).permute(0, 2, 3, 1)
