"""Where one chunk forward of the PyTorch port's ensembles spends its time.

    python3 scripts/trace_mc_torch.py [--chunk 16] [--warp shear|gather] [--train]
                                      [--replay [--chunks 8]] [--out _runs/trace_mc_torch.json]

Runs the canonical 31M U-Net (bf16, dependent DropBlock b=7 p=0.15,
conv_impl='pair' + mask_impl='fused', random seeded weights) on a 584x565
input, warms up, then profiles one chunk forward with torch.profiler. With
--warp, one chunk of the rotational ensemble instead: DropBlock off, the
chunk's angles warped in, the forward, the segmentations warped back by
their -angles (`shear`: kernel K4; `gather`: rotate_bilinear). With
--train, one train step of batch 1 instead (Trainer.train_step: bf16,
remat, DropBlock p=0.15 through the mask producer K2, conv_impl='pair' with
K3's backward, the masked BCE, SGD + momentum with clip 0.5). Prints
the wall time of the forward, the summed device time, the device's idle
share of the wall time, the device time by kernel, largest first, and the
host's busiest operators (self CPU time); then the mean wall time of
--repeat unprofiled calls in a row (synchronised once, at the end).
With --replay, the ensemble engine's device program instead (the MC
engine, or the rotational one under --warp): an engine of --chunks + 1
chunks and no saved members is warmed up and captured by two predict
calls, then one profiled window replays its --chunks body chunks in a row
(the epoch of replays a predict call makes); the numbers are per chunk.
Every run also reports the device's busy time as the union of its kernels'
intervals (`busy_ms`, `idle_share_union`; benchmark/tracing.py's
`union_seconds`): over graph replays the summed event times can exceed the
wall time. Kernels fall into the benchmark's kinds (`KINDS`, `kind_of`).
The counted window starts after a marker kernel, since a window can lose
the first kernels it records.
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

from benchmark.tracing import kind_of, union_seconds  # noqa: E402
from unet_research_tpu_torch.models import unet as tunet  # noqa: E402
from unet_research_tpu_torch.ops.cuda.shear_rotate import rotate_fan  # noqa: E402
from unet_research_tpu_torch.ops.image import rotate_bilinear  # noqa: E402
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig  # noqa: E402
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine, RotationalEngine  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--warp", choices=("shear", "gather"), default=None)
    p.add_argument("--train", action="store_true")
    p.add_argument("--replay", action="store_true")
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--out", default="_runs/trace_mc_torch.json")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    kind = "dependent" if a.warp is None else None
    db = tunet.DropBlockConfig(kind=kind, use_scheduler=False, drop_prob=0.15,
                               mask_impl="kernel" if a.train else "fused")
    cfg = tunet.canonical_config(dtype=torch.bfloat16, dropblock=db, remat=a.train)
    model = tunet.UNet(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    im = torch.rand((1, 584, 565, 1), generator=g).to(dev)
    x = im.expand(a.chunk, -1, -1, -1)
    # on the host for rotate_fan, on the card for rotate_bilinear, as the engine holds them
    angles = torch.arange(1, a.chunk + 1, dtype=torch.float32)
    if a.warp == "gather":
        angles = angles.to(dev)
    warp = {"shear": rotate_fan, "gather": rotate_bilinear}.get(a.warp)

    if a.train:
        trainer = Trainer(model, POLICIES["none"],
                          TrainerConfig(lr=1e-3, clip_norm=0.5, seed=0, verbose=False), device=dev)
        state = trainer.create_state()
        gt = (torch.rand((1, 584, 565, 1), generator=g) > 0.9).float().to(dev)
        fov = torch.ones_like(gt)

    def forward():
        if a.train:
            return trainer.train_step(state, im, gt, fov, 1e-3)
        with torch.inference_mode():
            if warp is not None:
                return warp(model(warp(im, angles)).contiguous(), -angles)
            keys = tunet.draw_site_keys(model.num_mask_sites(), g).to(dev)
            return model(x, drop_prob=0.15, site_keys=keys)

    per = 1
    if a.replay:
        fov = torch.ones_like(im)
        members = a.chunk * (a.chunks + 1)
        if a.warp is None:
            engine = MCDropBlockEngine(model, num_iterations=members, return_num=0,
                                       chunk=a.chunk, device=dev)
            call = lambda: engine.predict(im, im, fov, 0.15)  # noqa: E731
        else:
            engine = RotationalEngine(model, num_iterations=members, return_num=0,
                                      chunk=a.chunk, warp=a.warp, device=dev)
            call = lambda: engine.predict(im, im, fov)  # noqa: E731
        for _ in range(2):  # the warm-up chunk and the capture, then replays
            call()
        (prog,) = engine.programs.values()
        per = a.chunks

        def forward():
            with torch.inference_mode():
                prog.index.zero_()
                for _ in range(a.chunks):
                    prog.graph.replay()

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        forward()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)  # the marker after which events count
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / per
    device_events = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    marks = [ev for ev in device_events if "spin_kernel" in ev.name]
    if len(marks) != 1:
        raise SystemExit(f"{len(marks)} marker kernels in the profiled window")
    counted = [ev for ev in device_events if ev.time_range.start >= marks[0].time_range.end
               # user annotations (e.g. the optimizer's step range) are spans, not kernels
               and not getattr(ev, "is_user_annotation", False)]
    kernels = {}  # per call (per chunk under --replay)
    for ev in counted:
        kernels.setdefault(ev.name, [0.0, 0.0])
        kernels[ev.name][0] += ev.device_time / 1e3 / per
        kernels[ev.name][1] += 1 / per
    device_ms = sum(ms for ms, _ in kernels.values())
    busy = union_seconds((ev.time_range.start, ev.time_range.end) for ev in counted) / per * 1e3
    # the host's operators over the window's two calls, per call
    host = sorted(((ev.key, ev.self_cpu_time_total / 2e3 / per, ev.count / 2 / per)
                   for ev in prof.key_averages()), key=lambda r: -r[1])[:15]
    t0 = time.perf_counter()
    for _ in range(a.repeat):
        forward()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3 / a.repeat / per
    rows = sorted(([name, ms, n] for name, (ms, n) in kernels.items()),
                  key=lambda r: -r[1])
    by_kind = {}
    for name, ms, n in rows:
        acc = by_kind.setdefault(kind_of(name), [0.0, 0])
        acc[0] += ms
        acc[1] += n
    summary = {"device": torch.cuda.get_device_name(0), "chunk": 1 if a.train else a.chunk,
               "warp": a.warp, "train": a.train, "replay": a.replay,
               "chunks": per if a.replay else None,
               "wall_ms": wall_ms, "device_ms": device_ms, "unprofiled_ms": unprofiled_ms,
               "busy_ms": busy, "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
               "idle_share_union": max(0.0, 1.0 - busy / wall_ms),
               "launches": sum(n for _, _, n in rows),
               "by_kind": {k: {"ms": ms, "count": n} for k, (ms, n) in
                           sorted(by_kind.items(), key=lambda kv: -kv[1][0])},
               "kernels": [{"name": n[:160], "ms": ms, "count": c} for n, ms, c in rows],
               "host_self_ms": [{"name": n, "ms": ms, "count": c} for n, ms, c in host]}
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("kernels", "by_kind", "host_self_ms")}))
    for kind, row in summary["by_kind"].items():
        print(f"{row['ms']:9.3f} ms {row['count']:7.1f}x  [{kind}]")
    for r in summary["kernels"][:30]:
        print(f"{r['ms']:9.3f} ms {r['count']:6.1f}x  {r['name'][:110]}")
    for r in summary["host_self_ms"][:10]:
        print(f"{r['ms']:9.3f} ms {r['count']:7.1f}x  host {r['name'][:100]}")


if __name__ == "__main__":
    main()
