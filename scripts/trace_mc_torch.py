"""Where one chunk forward of the PyTorch port's ensembles spends its time.

    python3 scripts/trace_mc_torch.py [--chunk 16] [--warp shear|gather]
                                      [--out _runs/trace_mc_torch.json]

Runs the canonical 31M U-Net (bf16, dependent DropBlock b=7 p=0.15,
conv_impl='pair' + mask_impl='fused', random seeded weights) on a 584x565
input, warms up, then profiles one chunk forward with torch.profiler. With
--warp, one chunk of the rotational ensemble instead: DropBlock off, the
chunk's angles warped in, the forward, the segmentations warped back by
their -angles (`shear`: kernel K4; `gather`: rotate_bilinear). Prints
the wall time of the forward, the summed device time, the device's idle
share of the wall time, and the device time by kernel, largest first.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from unet_research_tpu_torch.models import unet as tunet  # noqa: E402
from unet_research_tpu_torch.ops.cuda.shear_rotate import rotate_fan  # noqa: E402
from unet_research_tpu_torch.ops.image import rotate_bilinear  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--warp", choices=("shear", "gather"), default=None)
    p.add_argument("--out", default="_runs/trace_mc_torch.json")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    kind = "dependent" if a.warp is None else None
    cfg = tunet.canonical_config(dtype=torch.bfloat16, dropblock=tunet.DropBlockConfig(kind=kind))
    model = tunet.UNet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    im = torch.rand((1, 584, 565, 1), generator=g).to(dev)
    x = im.expand(a.chunk, -1, -1, -1)
    # on the host for rotate_fan, on the card for rotate_bilinear, as the engine holds them
    angles = torch.arange(1, a.chunk + 1, dtype=torch.float32)
    if a.warp == "gather":
        angles = angles.to(dev)
    warp = {"shear": rotate_fan, "gather": rotate_bilinear}.get(a.warp)

    def forward():
        with torch.inference_mode():
            if warp is not None:
                return warp(model(warp(im, angles)).contiguous(), -angles)
            keys = tunet.draw_site_keys(model.num_mask_sites(), g).to(dev)
            return model(x, drop_prob=0.15, site_keys=keys)

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(ev.name, [0.0, 0])
            kernels[ev.name][0] += ev.device_time / 1e3
            kernels[ev.name][1] += 1
    device_ms = sum(ms for ms, _ in kernels.values())
    rows = sorted(([name, ms, n] for name, (ms, n) in kernels.items()),
                  key=lambda r: -r[1])
    summary = {"device": torch.cuda.get_device_name(0), "chunk": a.chunk, "warp": a.warp,
               "wall_ms": wall_ms, "device_ms": device_ms,
               "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
               "kernels": [{"name": n[:160], "ms": ms, "count": c} for n, ms, c in rows]}
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "kernels"}))
    for r in summary["kernels"][:30]:
        print(f"{r['ms']:9.3f} ms {r['count']:4d}x  {r['name'][:110]}")


if __name__ == "__main__":
    main()
