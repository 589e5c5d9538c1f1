"""Operations and bytes of the port's kernels K1-K3 and of the model, the
published peaks of one H100, and the card's power limit.

A launch's bound is max(bytes / HBM bandwidth, FLOP / bf16 peak). Bytes
count each input read once and each output written once, from the launch's
shapes (the weights and the per-sample GroupNorm coefficients and sums
included); FLOP are 2 x the multiply-adds. A kernel's roofline share is the
sum of its launches' bounds over the sum of their device times.

- K1 (fused DropBlock apply): reads x, writes out, both in the compute
  dtype; reads the (2, N, C) float32 coefficients, writes N keep counts.
- K2 (mask producer): writes the int8 keep-mask and N keep counts.
- K3 (3x3 SAME conv with GroupNorm sums, forward): reads x (C_in) and the
  3x3 x C_in x C_out weights, writes y (C_out) and two (N, C_out) float32
  sums; its dx launch reads g (C_out) and writes dx (C_in); the fold reads
  dy and y and writes g (C_out) and reads the two sums' cotangents.

Where each kernel runs in one forward is derived from the configuration as
the port's model gates it: K1 at every mask site (eval, DropBlock on), K2
at every mask site of a train step plus the remat re-runs of the sites in
conv blocks, K3 at each SAME 3x3 conv whose input has a multiple of 64
channels and whose output has at most 64, on an even canvas whose half
width is a multiple of 8.
"""

from __future__ import annotations

import subprocess

from benchmark.reference.unet import level_of, model_flops, param_specs

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM data sheet (700 W)
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM data sheet


def bound(nbytes: float, flops: float = 0.0) -> float:
    """The least seconds a launch can take on the card."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def canvas(cfg: dict, h: int, w: int) -> tuple:
    """The padded input size: H and W rounded up to a multiple of 2^depth."""
    m = 2 ** cfg["model_depth"]
    return -(-h // m) * m, -(-w // m) * m


def mask_sites(cfg: dict, h: int, w: int) -> list:
    """(h, w, c, in_block) of every mask site in call order on the padded
    canvas: in_block is False for a skip merge's site."""
    depth, f = cfg["model_depth"], cfg["filters"]
    sites = []
    for d in range(depth):
        sites += [(h >> d, w >> d, f << d, True)] * 2
    sites += [(h >> depth, w >> depth, f << depth, True)] * 2
    for d in range(depth):
        lv = depth - 1 - d
        c = f << lv
        sites.append((h >> lv, w >> lv, 2 * c, False))
        sites += [(h >> lv, w >> lv, c, True)] * 2
    return sites


def k3_sites(cfg: dict, h: int, w: int) -> list:
    """(h, w, c_in, c_out) of the convs K3 runs."""
    out = []
    if cfg.get("conv_impl") != "pair" or cfg.get("norm") is None:
        return out
    for name, shape, init in param_specs(cfg):
        if init != "conv" or shape[2:] != (3, 3):
            continue
        level = level_of(name, cfg["model_depth"])
        hh, ww = h >> level, w >> level
        c_out, c_in = shape[0], shape[1]
        if c_out <= 64 and c_in % 64 == 0 and hh % 2 == 0 and ww % 2 == 0 and (ww // 2) % 8 == 0:
            out.append((hh, ww, c_in, c_out))
    return out


def k1_bound(n, h, w, c, item: int = 2) -> float:
    return bound(2 * n * h * w * c * item + 2 * n * c * 4 + n * 8)


def k2_bound(n, h, w, c) -> float:
    return bound(n * h * w * c + n * 8)


def k3_bound(n, h, w, c_in, c_out, item: int = 2) -> float:
    nbytes = n * h * w * (c_in + c_out) * item + 9 * c_in * c_out * item + 2 * n * c_out * 4
    return bound(nbytes, 2.0 * 9 * c_in * c_out * n * h * w)


def fold_bound(n, h, w, c, item: int = 2) -> float:
    return bound(3 * n * h * w * c * item + 2 * n * c * 4)


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """FLOP of one forward of one image on its padded canvas."""
    return model_flops(cfg, *canvas(cfg, h, w))


def expected(cfg: dict, work: dict) -> dict:
    """{kernel group: (launches, summed bound in seconds)} of the work in a
    profiled window. work: {"forwards": [batch sizes], "h", "w", "dropblock"}
    for eval forwards, or {"steps", "rows", "h", "w"} for train steps (remat
    on, DropBlock on: the mask producer at every site)."""
    h, w = canvas(cfg, work["h"], work["w"])
    sites, convs = mask_sites(cfg, h, w), k3_sites(cfg, h, w)
    out = {}

    def add(group, launches, seconds):
        n0, s0 = out.get(group, (0, 0.0))
        out[group] = (n0 + launches, s0 + seconds)

    if "forwards" in work:
        for n in work["forwards"]:
            if work.get("dropblock"):
                add("k1", len(sites), sum(k1_bound(n, *s[:3]) for s in sites))
            add("k3", len(convs), sum(k3_bound(n, *cv) for cv in convs))
        return out
    n, steps = work["rows"], work["steps"]
    remat = cfg.get("remat", False)
    for _ in range(steps):
        for hh, ww, c, in_block in sites:
            times = 2 if (remat and in_block) else 1
            add("k2", times, times * k2_bound(n, hh, ww, c))
        for hh, ww, c_in, c_out in convs:
            times = 2 if remat else 1
            add("k3", times + 1, times * k3_bound(n, hh, ww, c_in, c_out)
                + k3_bound(n, hh, ww, c_out, c_in))
            add("k3", 1, fold_bound(n, hh, ww, c_out))
    return out
