"""The plain reference of the benchmark's Swin UNETR with the study's
DropBlock, in float32 PyTorch (tasks.plain_float32 turns TF32 off); it
imports nothing outside benchmark/.

Written from the published description (Hatamizadeh et al. 2022,
arXiv:2201.01266) and MONAI's code (monai/networks/nets/swin_unetr.py:
SwinUNETR with spatial_dims=2, use_v2=False, downsample "merging",
normalize=True; its SwinTransformer, BasicLayer, SwinTransformerBlock,
WindowAttention, PatchMerging, compute_mask and get_window_size;
monai/networks/blocks/unetr_block.py and dynunet_block.py for
UnetrBasicBlock, UnetrUpBlock, UnetResBlock and UnetOutBlock), one layer at
a time, with no kernel and no batching of its own. A configuration is a dict
(the benchmark's configuration file): feature_size, depths, heads, window,
mlp_ratio, init_channels, output_channels and dropblock {kind, block_size}.

Parameters are a mapping from the port's state-dict names to float32
tensors (`param_specs` lists them, with how the benchmark seeds each).
DropBlock draws its masks by the counter hash of reference/transunet.py's
`Drop`, each site rescaling by its own sample's keep count. `quant` (the
control) keeps every layer's output and every weight in float8 (e4m3).

Departures from the published model, each at its line: 2D (the paper's is
3D); one input channel (published: 4 MRI modalities); one output with a
sigmoid, the study's vessel map (published: BraTS's 3 sigmoid channels);
the input zero-padded at its bottom and right to a multiple of 32, which
MONAI requires, and the output cropped back; the DropBlock plug-in at 15
sites.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.transunet import Drop, _Quant

__all__ = ["Drop", "canvas", "compute_mask", "forward", "mask_sites", "model_flops",
           "num_sites", "param_specs", "relative_position_index", "window_geometry"]

LN_EPS, IN_EPS, SLOPE, MASKED = 1e-5, 1e-5, 0.01, -100.0
MULTIPLE = 32  # patch 2 and four merges: MONAI asks every side to divide by 2^5


# --- the configuration's shapes ----------------------------------------------------

def widths(cfg: dict) -> list:
    """The channels of the embedding and of each stage's merged output: fs,
    2fs, 4fs, 8fs, 16fs."""
    return [cfg["feature_size"] << s for s in range(len(cfg["depths"]) + 1)]


# (name, input channels, output channels) of the CNN's residual blocks, and of
# the up blocks (whose residual block takes twice the output channels)
def encoders(cfg: dict) -> list:
    c = widths(cfg)
    return [("encoder1", cfg["init_channels"], c[0]), ("encoder2", c[0], c[0]),
            ("encoder3", c[1], c[1]), ("encoder4", c[2], c[2]), ("encoder10", c[4], c[4])]


def decoders(cfg: dict) -> list:
    c = widths(cfg)
    return [("decoder5", c[4], c[3]), ("decoder4", c[3], c[2]), ("decoder3", c[2], c[1]),
            ("decoder2", c[1], c[0]), ("decoder1", c[0], c[0])]


def param_specs(cfg: dict) -> list:
    """[(name, shape, init, fan_in)] in state-dict order. init: 'uniform'
    (U(+-1/sqrt(fan_in)), fan_in the terms of each output: conv, transposed
    conv and linear weights and biases), 'one', 'zero' (LayerNorms' weights
    and biases), 'table' (the relative-position tables, N(0, 0.02)).
    InstanceNorm has no parameters (MONAI's: affine False)."""
    specs = []

    def conv(name, cout, cin, k, bias=False):
        specs.append((f"{name}.weight", (cout, cin, k, k), "uniform", cin * k * k))
        if bias:
            specs.append((f"{name}.bias", (cout,), "uniform", cin * k * k))

    def linear(name, cout, cin, bias=True):
        specs.append((f"{name}.weight", (cout, cin), "uniform", cin))
        if bias:
            specs.append((f"{name}.bias", (cout,), "uniform", cin))

    def norm(name, c):
        specs.extend([(f"{name}.weight", (c,), "one", 0), (f"{name}.bias", (c,), "zero", 0)])

    def res_block(name, cin, cout):
        conv(f"{name}.conv1", cout, cin, 3)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.conv3", cout, cin, 1)

    c, win = widths(cfg), cfg["window"]
    conv("patch_embed", c[0], cfg["init_channels"], 2, bias=True)
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        for b in range(depth):
            pre = f"layers.{s}.blocks.{b}"
            norm(f"{pre}.norm1", c[s])
            specs.append((f"{pre}.attn.relative_position_bias_table",
                          ((2 * win - 1) ** 2, heads), "table", 0))
            linear(f"{pre}.attn.qkv", 3 * c[s], c[s])
            linear(f"{pre}.attn.proj", c[s], c[s])
            norm(f"{pre}.norm2", c[s])
            linear(f"{pre}.mlp.linear1", cfg["mlp_ratio"] * c[s], c[s])
            linear(f"{pre}.mlp.linear2", c[s], cfg["mlp_ratio"] * c[s])
        norm(f"layers.{s}.downsample.norm", 4 * c[s])
        linear(f"layers.{s}.downsample.reduction", 2 * c[s], 4 * c[s], bias=False)
    for name, cin, cout in encoders(cfg):
        res_block(name, cin, cout)
    for name, cin, cout in decoders(cfg):
        # ConvTranspose2d's (in, out, 2, 2) weight at stride 2: each output sums
        # one input pixel's `in` channels
        specs.append((f"{name}.transp_conv.weight", (cin, cout, 2, 2), "uniform", cin))
        res_block(f"{name}.conv_block", 2 * cout, cout)
    conv("out", cfg["output_channels"], c[0], 1, bias=True)
    return specs


def num_sites(cfg: dict) -> int:
    """Mask sites: the first norm of each of the 10 residual blocks and each
    of the 5 decoder concatenations."""
    return len(encoders(cfg)) + 2 * len(decoders(cfg))


def canvas(h: int, w: int) -> tuple:
    """The padded input: H and W rounded up to a multiple of 32."""
    return -(-h // MULTIPLE) * MULTIPLE, -(-w // MULTIPLE) * MULTIPLE


def mask_sites(cfg: dict, h: int, w: int) -> list:
    """(h, w, c) of every mask site in call order on the padded h x w
    canvas: the encoders' first norms, then per decoder block its
    concatenation and its residual block's first norm."""
    scale = {"encoder1": 0, "encoder2": 1, "encoder3": 2, "encoder4": 3, "encoder10": 5}
    sites = [(h >> scale[name], w >> scale[name], cout) for name, _, cout in encoders(cfg)]
    for level, (_, _, cout) in zip((4, 3, 2, 1, 0), decoders(cfg)):
        sites += [(h >> level, w >> level, 2 * cout), (h >> level, w >> level, cout)]
    return sites


# --- windows: MONAI's get_window_size, relative_position_index, compute_mask --------

def window_geometry(h: int, w: int, window: int) -> tuple:
    """((window h, w), (shift h, w)) of a shifted block on an h x w grid: the
    window clipped to a side that is no longer than it, and the shift 0
    there (get_window_size)."""
    ws, ss = [window, window], [window // 2, window // 2]
    for i, side in enumerate((h, w)):
        if side <= window:
            ws[i], ss[i] = side, 0
    return tuple(ws), tuple(ss)


def relative_position_index(window: int) -> torch.Tensor:
    """(window^2, window^2) int64: the row of the (2 window - 1)^2 table that
    holds the bias between two tokens of a window, by their offset."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


def _partition(x: torch.Tensor, ws: tuple) -> torch.Tensor:
    """NHWC (n, h, w, c) -> (n * windows, wh * ww, c), windows row-major."""
    n, h, w, c = x.shape
    x = x.view(n, h // ws[0], ws[0], w // ws[1], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws[0] * ws[1], c)


def _reverse(x: torch.Tensor, ws: tuple, n: int, h: int, w: int) -> torch.Tensor:
    x = x.view(n, h // ws[0], w // ws[1], ws[0], ws[1], -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def compute_mask(hp: int, wp: int, ws: tuple, ss: tuple) -> torch.Tensor:
    """(windows, T, T) float32 additive mask of the shifted block on the
    padded hp x wp grid: the grid cut into 3 x 3 regions by the slices
    (0, -window), (-window, -shift), (-shift, None) of each axis (a later
    slice overwriting an earlier one, as where a shift of 0 makes the last
    slice the whole axis), -100.0 between tokens of different regions."""
    img = torch.zeros((1, hp, wp, 1))
    cnt = 0
    for hs in (slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for wsl in (slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    windows = _partition(img, ws).squeeze(-1)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.where(diff != 0, torch.tensor(MASKED), torch.tensor(0.0))


# --- the operations and bytes --------------------------------------------------------

def swin_grids(cfg: dict, h: int, w: int) -> list:
    """(grid h, w, padded h, w, window h, w) of each stage on the padded
    h x w canvas."""
    out, gh, gw = [], h // 2, w // 2
    for _ in cfg["depths"]:
        ws, _ = window_geometry(gh, gw, cfg["window"])
        out.append((gh, gw, -(-gh // ws[0]) * ws[0], -(-gw // ws[1]) * ws[1], *ws))
        gh, gw = -(-gh // 2), -(-gw // 2)
    return out


def model_flops(cfg: dict, h: int, w: int) -> float:
    """2 x the multiply-adds of one forward of one image on the padded h x w
    canvas: every conv and transposed conv (at its output's size), the patch
    embedding, every linear layer (qkv and proj over the padded windows'
    tokens, the MLP and the merge over the grid's), and the window
    attention's two products (q k^T and A v, T x C a token of a window)."""
    c = widths(cfg)
    macs = (h // 2) * (w // 2) * c[0] * cfg["init_channels"] * 4
    for s, (gh, gw, hp, wp, wh, ww) in enumerate(swin_grids(cfg, h, w)):
        cs, t = c[s], wh * ww
        per_block = hp * wp * (4 * cs * cs + 2 * t * cs) + gh * gw * 2 * cfg["mlp_ratio"] * cs * cs
        macs += cfg["depths"][s] * per_block
        macs += -(-gh // 2) * -(-gw // 2) * 4 * cs * 2 * cs
    scale = {"encoder1": 0, "encoder2": 1, "encoder3": 2, "encoder4": 3, "encoder10": 5}
    for name, cin, cout in encoders(cfg):
        hw = (h >> scale[name]) * (w >> scale[name])
        macs += hw * cout * (9 * cin + 9 * cout + (cin if cin != cout else 0))
    for level, (_, cin, cout) in zip((4, 3, 2, 1, 0), decoders(cfg)):
        hw = (h >> level) * (w >> level)
        macs += hw * cin * cout  # the transposed conv: one input pixel per output
        macs += hw * cout * (9 * 2 * cout + 9 * cout + 2 * cout)
    macs += h * w * c[0] * cfg["output_channels"]
    return 2.0 * macs


# --- the forward ----------------------------------------------------------------------

def forward(params: dict, x: torch.Tensor, cfg: dict, drop: Drop | None = None,
            quant: bool = False) -> torch.Tensor:
    """x: NHWC float32 (N, H, W, C) -> (N, H, W, 1) float32 in [0, 1].
    drop: the DropBlock state, or None for DropBlock off. quant: the control
    (module docstring). The parameters' dtype is the arithmetic's (float64
    parameters: a float64 forward). InstanceNorm takes each sample's own statistics in
    training and in eval alike, so there is no train mode."""
    p = params
    h0, w0 = x.shape[1], x.shape[2]
    site = [0]

    def store(t):
        return _Quant.apply(t) if quant else t

    def conv(x, name, **kw):
        bias = p.get(f"{name}.bias")
        return store(F.conv2d(x, store(p[f"{name}.weight"]),
                              None if bias is None else store(bias), **kw))

    def linear(x, name):
        bias = p.get(f"{name}.bias")
        return store(F.linear(x, store(p[f"{name}.weight"]), None if bias is None else store(bias)))

    def ln(x, name=None):  # over the channels (last); name None: no affine (proj_out)
        if name is None:
            return store(F.layer_norm(x, (x.shape[-1],), eps=LN_EPS))
        return store(F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"],
                                  LN_EPS))

    def inorm(x):  # InstanceNorm2d, no affine, biased variance
        return store(F.instance_norm(x, eps=IN_EPS))

    def lrelu(x):
        return store(F.leaky_relu(x, SLOPE))

    def masked(x):
        if drop is not None:
            x = drop(x, site[0])
        site[0] += 1
        return x

    # --- the Swin transformer (NHWC tokens) ---

    def attention(x, pre, heads, mask, ws):
        b, t, c = x.shape
        qkv = linear(x, f"{pre}.qkv").reshape(b, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
        att = q @ k.transpose(-2, -1)
        # MONAI takes the first t rows and columns of the configured window's
        # index, also where the window was clipped to a shorter grid
        index = relative_position_index(cfg["window"])[:t, :t].reshape(-1)
        bias = store(p[f"{pre}.relative_position_bias_table"])[index].reshape(t, t, heads)
        att = att + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            att = (att.view(b // nw, nw, heads, t, t) + mask[None, :, None]).view(b, heads, t, t)
        att = store(torch.softmax(att, dim=-1))
        o = store(att @ v).transpose(1, 2).reshape(b, t, c)
        return linear(o, f"{pre}.proj")

    def block(x, pre, heads, ws, ss, mask):
        n, h, w, c = x.shape
        a = ln(x, f"{pre}.norm1")
        # padded after the norm: the pad tokens are zeros, keys and values as MONAI has them
        a = F.pad(a, (0, 0, 0, -w % ws[1], 0, -h % ws[0]))
        hp, wp = a.shape[1], a.shape[2]
        shifted = any(s > 0 for s in ss)
        if shifted:
            a = torch.roll(a, shifts=(-ss[0], -ss[1]), dims=(1, 2))
        y = attention(_partition(a, ws), f"{pre}.attn", heads, mask if shifted else None, ws)
        a = _reverse(y, ws, n, hp, wp)
        if shifted:
            a = torch.roll(a, shifts=ss, dims=(1, 2))
        x = store(x + a[:, :h, :w])
        a = ln(x, f"{pre}.norm2")
        a = linear(store(F.gelu(linear(a, f"{pre}.mlp.linear1"))), f"{pre}.mlp.linear2")
        return store(x + a)

    def merge(x, pre):
        n, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return linear(ln(x, f"{pre}.norm"), f"{pre}.reduction")

    def swin(x):
        x = conv(x, "patch_embed", stride=2).permute(0, 2, 3, 1)
        hidden = [ln(x)]
        for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
            h, w = x.shape[1], x.shape[2]
            ws, ss = window_geometry(h, w, cfg["window"])
            hp, wp = -(-h // ws[0]) * ws[0], -(-w // ws[1]) * ws[1]
            mask = compute_mask(hp, wp, ws, ss).to(x.device)
            for b in range(depth):  # every second block shifted
                x = block(x, f"layers.{s}.blocks.{b}", heads, ws,
                          ss if b % 2 else (0, 0), mask)
            x = merge(x, f"layers.{s}.downsample")
            hidden.append(ln(x))
        return [t.permute(0, 3, 1, 2) for t in hidden]

    # --- the CNN (NCHW) ---

    def res_block(x, pre):
        y = lrelu(masked(inorm(conv(x, f"{pre}.conv1", padding=1))))
        y = inorm(conv(y, f"{pre}.conv2", padding=1))
        r = inorm(conv(x, f"{pre}.conv3")) if f"{pre}.conv3.weight" in p else x
        return lrelu(y + r)

    def up_block(x, skip, pre):
        u = store(F.conv_transpose2d(x, store(p[f"{pre}.transp_conv.weight"]), stride=2))
        return res_block(masked(torch.cat([u, skip], dim=1)), f"{pre}.conv_block")

    # the canvas: zero-padded at the bottom and right to a multiple of 32 (a departure)
    x = x.permute(0, 3, 1, 2).to(p["patch_embed.weight"].dtype)
    x = store(F.pad(x, (0, -w0 % MULTIPLE, 0, -h0 % MULTIPLE)))
    hidden = swin(x)
    enc0 = res_block(x, "encoder1")
    enc1 = res_block(hidden[0], "encoder2")
    enc2 = res_block(hidden[1], "encoder3")
    enc3 = res_block(hidden[2], "encoder4")
    dec = res_block(hidden[4], "encoder10")
    for (name, _, _), skip in zip(decoders(cfg), (hidden[3], enc3, enc2, enc1, enc0)):
        dec = up_block(dec, skip, name)
    # one output and a sigmoid: the study's vessel map (a departure from BraTS's 3)
    x = torch.sigmoid(conv(dec, "out"))[:, :, :h0, :w0]
    return torch.nan_to_num(torch.clamp(x, 0.0, 1.0), nan=0.0).permute(0, 2, 3, 1)
