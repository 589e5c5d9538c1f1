"""Times of the port's K1-K4 kernels at the main-path shapes, for the package
in a given source tree, so that two trees can be compared on one card in
turns.

    python3 scripts/kernel_times_torch.py [--root DIR] [--tag NAME]

Imports `unet_research_tpu_torch` from DIR (default: this checkout), builds
its kernels, and prints one JSON line: the card's name and power limit, and
per kernel the event time per call (ms) and, at batch 1, the device time per
call from torch.profiler (device_ms):

- K1 `dropblock_fused_apply` and K2 `dropblock_mask` at (16, 592, 576, 64),
  bf16, b = 7 at the canonical drop probability, and in device time at
  batch 1 (the training shape); K2 again with the threshold read from a
  device word (`K2_thr_*`);
- K3 forward with the sums at (16|1, 592, 576, 64|128) -> 64, bf16;
- K3's backward route at (1, 592, 576, 64|128) -> 64 (autograd of
  conv3x3_pair with cotangents on y and both sums), and its dx call alone,
  `conv3x3_pair_dx(dy, K, y, ds1, ds2)` with the fold (`dx_ms`);
- `conv3x3_pair_valid` at (1, 592, 576, 64) -> 64;
- K4 `rotate_fan` on the rotational chunk's two fans at 584x565 (K = 16,
  the ties 45 + 90k included): one image to 16 angles (`K4_fwd`) and 16
  images back by their -angles (`K4_inv`), the device time per call from
  torch.profiler and the event time per call; then its table launch,
  `rotate_fan_table` on the same fans, their rows read on the card
  (`K4_table_fwd_*`, `K4_table_inv_*`).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.roofline import power_limit  # noqa: E402

H, W, CHUNK, BLOCK, P_DROP = 592, 576, 16, 7, 0.15
# chip_smoke.py's rotational chunk
FAN = [45.0, 135.0, 225.0, 315.0, 1.0, 17.0, 33.0, 60.0, 90.0, 101.0, 180.0, 200.5, 270.0,
       300.0, 333.0, 359.0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.device_time for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / iters


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--tag", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(a.root))
    from unet_research_tpu_torch.models import unet as tunet
    from unet_research_tpu_torch.ops.cuda import build
    from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk
    from unet_research_tpu_torch.ops.cuda import pair_conv as pc
    from unet_research_tpu_torch.ops.cuda import shear_rotate as sr
    from unet_research_tpu_torch.ops.dropblock import dropblock_gamma_dependent

    build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def weights(cin):
        return (0.05 * randn(3, 3, cin, 64, dtype=torch.float32)).to(torch.bfloat16)

    out = {"tag": a.tag, "root": a.root, "card": power_limit()}
    gamma = dropblock_gamma_dependent(H, W, BLOCK, P_DROP)
    key = tunet.draw_site_keys(1, torch.Generator().manual_seed(3))[0].to(dev)
    x = randn(CHUNK, H, W, 64)
    ab = torch.stack([1.0 + 0.1 * randn(CHUNK, 64, dtype=torch.float32),
                      0.1 * randn(CHUNK, 64, dtype=torch.float32)]).contiguous()
    out["K1_ms"] = time_ms(lambda: dbk.dropblock_fused_apply(x, ab, key, gamma, BLOCK), 20)
    out["K2_ms"] = time_ms(lambda: dbk.dropblock_mask(tuple(x.shape), key, gamma, BLOCK), 20)
    # batch 1, as training runs K2 (and K1 would)
    x1, ab1 = x[:1].contiguous(), ab[:, :1].contiguous()
    out["K1_b1_device_ms"] = device_ms(
        lambda: dbk.dropblock_fused_apply(x1, ab1, key, gamma, BLOCK))
    out["K2_b1_device_ms"] = device_ms(
        lambda: dbk.dropblock_mask(tuple(x1.shape), key, gamma, BLOCK))
    # K2 reading its threshold from a device word (the scanned train step)
    thr = torch.tensor(dbk.seed_threshold(gamma), dtype=torch.int64, device=dev)
    out["K2_thr_ms"] = time_ms(
        lambda: dbk.dropblock_mask(tuple(x.shape), key, None, BLOCK, threshold=thr), 20)
    out["K2_thr_b1_device_ms"] = device_ms(
        lambda: dbk.dropblock_mask(tuple(x1.shape), key, None, BLOCK, threshold=thr))
    del x, ab

    for cin in (64, 128):
        w = weights(cin)
        for n in (CHUNK, 1):
            x = randn(n, H, W, cin)
            fwd = lambda: pc.conv3x3_pair(x, w, stats=True)  # noqa: E731
            out[f"K3_fwd_{cin}_b{n}_ms"] = time_ms(fwd, 10 if n > 1 else 50)
            if n == 1:
                out[f"K3_fwd_{cin}_b1_device_ms"] = device_ms(fwd)
        cots = (randn(1, H, W, 64), 0.5 * randn(1, 64, dtype=torch.float32),
                0.5 * randn(1, 64, dtype=torch.float32))
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        outs = pc.conv3x3_pair(xr, wr, stats=True)
        route = lambda: torch.autograd.grad(outs, (xr, wr), cots, retain_graph=True)  # noqa: E731
        out[f"K3_bwd_{cin}_ms"] = time_ms(route, 20)
        out[f"K3_bwd_{cin}_device_ms"] = device_ms(route)
        y = outs[0].detach()
        dx = lambda: pc.conv3x3_pair_dx(cots[0], w, y, cots[1], cots[2])  # noqa: E731
        out[f"K3_dx_{cin}_ms"] = time_ms(dx, 50)
        out[f"K3_dx_{cin}_device_ms"] = device_ms(dx)
    x, w = randn(1, H, W, 64), weights(64)
    valid = lambda: pc.conv3x3_pair_valid(x, w)  # noqa: E731
    out["K3_valid_ms"] = time_ms(valid, 50)
    out["K3_valid_device_ms"] = device_ms(valid)
    fan = torch.tensor(FAN)
    im = torch.rand((1, 584, 565, 1), device=dev, generator=gen)
    segs = torch.rand((len(FAN), 584, 565, 1), device=dev, generator=gen)
    for name, (img, angles) in {"fwd": (im, fan), "inv": (segs, -fan)}.items():
        warp = lambda: sr.rotate_fan(img, angles)  # noqa: E731
        out[f"K4_{name}_device_ms"] = device_ms(warp)
        out[f"K4_{name}_ms"] = time_ms(warp, 20)
    index = torch.zeros(1, dtype=torch.int64, device=dev)
    for name, (img, sign) in {"fwd": (im, 1.0), "inv": (segs, -1.0)}.items():
        table = sr.member_table([sign * fan], 584, 565, dev)
        warp = lambda: sr.rotate_fan_table(img, table, index)  # noqa: E731
        out[f"K4_table_{name}_device_ms"] = device_ms(warp)
        out[f"K4_table_{name}_ms"] = time_ms(warp, 20)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
