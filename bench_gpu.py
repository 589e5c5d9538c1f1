"""Headline benchmark of the PyTorch/CUDA port: MC-DropBlock passes/sec on one card.

The twin of bench.py, which drives the JAX package. The workload is
bench.py's `measure`, written against the port: the canonical 31M U-Net in
bfloat16 with dependent DropBlock (block 7, p 0.15, no scheduler) at its 22
mask sites, a 584x565 image from np.random.default_rng(0), 1000 members in
chunks of 16 with none saved, two warm-up `predict` calls, then the best of
three timed ones, each with a freshly seeded generator. On the card the
ensemble's uniform body chunks replay as one CUDA graph
(uncertainty/ensemble.py::EnsembleProgram); the default pipeline is the
port's main path, K3 (conv3x3_pair) and K1 (the fused DropBlock apply).

    python3 bench_gpu.py                     # the headline, on the card
    BENCH_RESIZE=256 python3 bench_gpu.py    # the secondary workload (chunk 128)

Prints ONE JSON line: bench.py's keys ("metric", "value", "unit",
"vs_baseline" against BASELINE.json's 1000 passes/sec, "pipeline"), the card
as `nvidia-smi --query-gpu=name,power.limit` gives it, the three timed
seconds ("times"), the two warm-ups' seconds, the capture included
("warmup_s"), the device, and the kernel launches of each timed call.

Environment (bench.py's knobs, with its JAX names for the routes):
  UNET_CONV_IMPL   pair (default) | xla: cuDNN everywhere (conv_impl='torch')
  UNET_DB_IMPL     fused (default) | kernel | elementwise
  BENCH_ITERS, BENCH_CHUNK, BENCH_RESIZE, BENCH_HW=HxW, BENCH_FILTERS,
  BENCH_DEPTH, BENCH_GROUPS    the workload's size; the metric's name
                               follows BENCH_HW and BENCH_RESIZE
  BENCH_ATTEMPTS, BENCH_RETRY_SLEEP   the bounded retry of the device claim
  BENCH_DEVICES=N>1   the split ensemble over N ranks, one card each
                      (parallel/launch.py::spawn); more than the host's
                      cards raises
  BENCH_DEVICE=cpu    run on the CPU, where the kernels' plain versions
                      run (for tests; no speed is measured there)
  BENCH_SIM_INIT_FAIL=N, BENCH_SIM_MEASURE_FAIL=N   fail the first N device
                      claims or measurements (test hooks)

Unlike bench.py there is no fallback pipeline: a kernel that fails to build
or launch, a failed measurement and a missing card each end the run with a
non-zero exit and no JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from unet_research_tpu_torch.cli.common import CONV_IMPLS
from unet_research_tpu_torch.models.unet import DropBlockConfig, UNet, canonical_config
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.parallel import launch
from unet_research_tpu_torch.parallel.mesh import make_mesh
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine

DEFAULT_CONV_IMPL = "pair"
DEFAULT_MASK_IMPL = "fused"
MASK_IMPLS = ("fused", "kernel", "elementwise")
NATIVE_CHUNK = 16
R256_CHUNK = 128
DROP_PROB = 0.15
BASELINE_PASSES_PER_S = 1000.0  # BASELINE.json's target, as bench.py scores it
TIMED_CALLS = 3
WARMUP_CALLS = 2


@dataclasses.dataclass(frozen=True)
class Workload:
    """What one measurement runs: `iters` members of a `hw` image (square-
    padded and resized to `resize` first when nonzero) in chunks of
    `chunk`, on a model with `tiny`'s UNetConfig overrides, over `devices`
    ranks on `device` ('cuda' or 'cpu')."""

    iters: int = 1000
    hw: tuple = (584, 565)
    resize: int = 0
    chunk: int = NATIVE_CHUNK
    tiny: dict = dataclasses.field(default_factory=dict)
    devices: int = 1
    device: str = "cuda"

    @classmethod
    def from_env(cls, env=os.environ, iters: int = 1000) -> "Workload":
        resize = int(env.get("BENCH_RESIZE", 0))
        h, w = (int(v) for v in env.get("BENCH_HW", "584x565").split("x"))
        tiny = {field: int(env[var]) for field, var in (("filters", "BENCH_FILTERS"),
                                                        ("model_depth", "BENCH_DEPTH"),
                                                        ("group_norm_groups", "BENCH_GROUPS"))
                if env.get(var)}
        device = env.get("BENCH_DEVICE", "cuda")
        if device not in ("cuda", "cpu"):
            raise ValueError(f"BENCH_DEVICE={device!r}: expected cuda or cpu")
        return cls(iters=int(env.get("BENCH_ITERS", iters)), hw=(h, w), resize=resize,
                   chunk=int(env.get("BENCH_CHUNK", 0)) or (R256_CHUNK if resize else NATIVE_CHUNK),
                   tiny=tiny, devices=max(1, int(env.get("BENCH_DEVICES", 0))), device=device)

    def metric(self) -> str:
        size = f"resize{self.resize}" if self.resize else f"{self.hw[0]}x{self.hw[1]}"
        return f"mc_dropblock_passes_per_sec_{size}_{self.devices}chip"


def pipeline_from_env(env=os.environ) -> tuple[str, str]:
    """(conv, mask) in bench.py's names, from UNET_CONV_IMPL / UNET_DB_IMPL."""
    conv = env.get("UNET_CONV_IMPL") or DEFAULT_CONV_IMPL
    mask = env.get("UNET_DB_IMPL") or DEFAULT_MASK_IMPL
    if conv not in CONV_IMPLS:
        raise ValueError(f"UNET_CONV_IMPL={conv!r}: expected one of {sorted(CONV_IMPLS)}")
    if mask not in MASK_IMPLS:
        raise ValueError(f"UNET_DB_IMPL={mask!r}: expected one of {sorted(MASK_IMPLS)}")
    return conv, mask


def pipeline_name(conv: str, mask: str) -> str:
    """bench.py's `conv+mask`, with the port's conv_impl beside a JAX name
    that differs from it: 'xla(torch)+fused' runs cuDNN."""
    port = CONV_IMPLS[conv]
    return f"{conv}+{mask}" if port == conv else f"{conv}({port})+{mask}"


def model_config(conv: str, mask: str, tiny: dict, dtype=torch.bfloat16):
    """bench.py's model (bench.py:162-177) as the port's UNetConfig."""
    db = DropBlockConfig(kind="dependent", block_size=7, drop_prob=DROP_PROB,
                         use_scheduler=False, mask_impl=mask)
    return canonical_config(dtype=dtype, dropblock=db, conv_impl=CONV_IMPLS[conv], **tiny)


def build_model(conv: str, mask: str, tiny: dict, device, dtype=torch.bfloat16) -> UNet:
    """The benchmark's model with seeded random weights, in eval mode."""
    model = UNet(model_config(conv, mask, tiny, dtype), device=device,
                 generator=torch.Generator().manual_seed(0))
    return model.eval()


def bench_input(hw: tuple):
    """bench.py's (im, gt, mask): a uniform image, no vessels, all FOV."""
    im = np.random.default_rng(0).random((1, *hw, 1), dtype=np.float32)
    return im, np.zeros_like(im), np.ones_like(im)


def make_engine(model: UNet, work: Workload, device, mesh=None,
                program: bool = True) -> MCDropBlockEngine:
    return MCDropBlockEngine(model, num_iterations=work.iters, return_num=0, chunk=work.chunk,
                             resize=work.resize or -1, device=device, mesh=mesh, program=program)


def measure(engine: MCDropBlockEngine, work: Workload) -> dict:
    """bench.py's measure on `engine`: two warm-up predicts (generators
    seeded 0 and 1; the first captures the device program), then three
    timed ones with time-salted seeds. The barrier is a synchronize and a
    host read of mean.sum() + std.sum(). Returns the passes/sec of the
    fastest call, every call's seconds, the seeds, each timed call's kernel
    launches, whether the timed calls replayed the program that the warm-up
    captured, and the last call's mean and std."""
    sim = int(os.environ.get("BENCH_SIM_MEASURE_FAIL", 0))
    if sim > 0:
        os.environ["BENCH_SIM_MEASURE_FAIL"] = str(sim - 1)
        raise RuntimeError("simulated measurement failure")
    im, gt, mask = bench_input(work.hw)

    def predict(seed: int):
        mean, std, *_ = engine.predict(im, gt, mask, DROP_PROB,
                                       generator=torch.Generator().manual_seed(seed))
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        float(mean.sum() + std.sum())
        return mean, std

    warmup_s = []
    for seed in range(WARMUP_CALLS):
        t0 = time.perf_counter()
        predict(seed)
        warmup_s.append(time.perf_counter() - t0)
    graphs = [prog.graph for prog in engine.programs.values()]

    salt = time.time_ns() & 0x7FFFFFFF
    seeds = [salt + i for i in range(TIMED_CALLS)]
    times, counts = [], []
    for seed in seeds:
        before = launches.snapshot()
        t0 = time.perf_counter()
        mean, std = predict(seed)
        times.append(time.perf_counter() - t0)
        counts.append(launches.since(before))
    programs = list(engine.programs.values())
    return {"passes_per_s": work.iters / min(times), "times": times, "warmup_s": warmup_s,
            "seeds": seeds, "launches": counts, "programs": len(programs),
            "program_reused": len(programs) == len(graphs)
                              and all(p.graph is g for p, g in zip(programs, graphs)),
            "capture_s": [p.capture_seconds for p in programs], "mean": mean, "std": std}


def _rank_measure(work: Workload, conv: str, mask: str) -> dict:
    """One rank of BENCH_DEVICES: the split ensemble on this rank's device."""
    mesh = make_mesh(data=work.devices, device=None if work.device == "cuda" else "cpu")
    engine = make_engine(build_model(conv, mask, work.tiny, mesh.device), work, mesh.device,
                         mesh=mesh)
    out = measure(engine, work)
    return {k: v for k, v in out.items() if k not in ("mean", "std")}


def run(work: Workload, conv: str, mask: str) -> dict:
    """measure() of the benchmark's model on `work`; over BENCH_DEVICES ranks
    (cuda:0..N-1, or CPU ranks over gloo) rank 0's measurement, without
    the outputs."""
    if work.devices > 1:
        if work.device == "cpu":
            return launch.spawn(_rank_measure, (work, conv, mask), ["cpu"] * work.devices,
                                backend="gloo")
        return launch.spawn(_rank_measure, (work, conv, mask),
                            [f"cuda:{r}" for r in range(work.devices)])
    device = torch.device(work.device)
    return measure(make_engine(build_model(conv, mask, work.tiny, device), work, device), work)


def _claim(work: Workload) -> int:
    """The devices' count, the card's runtime initialised first."""
    sim = int(os.environ.get("BENCH_SIM_INIT_FAIL", 0))
    if sim > 0:
        os.environ["BENCH_SIM_INIT_FAIL"] = str(sim - 1)
        raise RuntimeError("CUDA initialisation failed: simulated")
    if work.device == "cpu":
        return work.devices
    torch.cuda.init()
    return torch.cuda.device_count()


def claim_devices(work: Workload, attempts: int, sleep_s: float) -> int:
    """Claim the devices with a bounded retry (bench.py's
    _devices_with_retry). A host without a card exits at once: that is not
    a transient failure. More ranks than cards raise."""
    if work.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_gpu: CUDA is not available: no card to measure on "
                         "(BENCH_DEVICE=cpu runs on the CPU, for tests)")
    last = None
    for i in range(attempts):
        try:
            count = _claim(work)
            break
        except RuntimeError as e:
            last = e
            print(f"bench_gpu: device claim failed (attempt {i + 1}/{attempts}): {e}",
                  file=sys.stderr, flush=True)
            if i + 1 < attempts:
                time.sleep(sleep_s)
    else:
        raise last
    if work.devices > count:
        raise ValueError(f"BENCH_DEVICES={work.devices}: this host has {count} cards")
    return count


def card(work: Workload):
    """The card's name and power limit as nvidia-smi gives them; None on
    the CPU."""
    if work.device == "cpu":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def device_info(work: Workload) -> dict:
    kind = torch.cuda.get_device_name(0) if work.device == "cuda" else "cpu"
    return {"platform": "gpu" if work.device == "cuda" else "cpu", "kind": kind,
            "count": work.devices}


def result_line(work: Workload, conv: str, mask: str, out: dict) -> dict:
    value = out["passes_per_s"]
    return {"metric": work.metric(), "value": round(value, 2), "unit": "passes/sec",
            "vs_baseline": round(value / BASELINE_PASSES_PER_S, 4),
            "pipeline": pipeline_name(conv, mask), "card": card(work), "times": out["times"],
            "warmup_s": out["warmup_s"], "device": device_info(work), "iterations": work.iters,
            "chunk": work.chunk, "launches_per_predict": out["launches"]}


def main() -> None:
    work = Workload.from_env()
    conv, mask = pipeline_from_env()
    claim_devices(work, int(os.environ.get("BENCH_ATTEMPTS", 3)),
                  float(os.environ.get("BENCH_RETRY_SLEEP", 120)))
    print(json.dumps(result_line(work, conv, mask, run(work, conv, mask))), flush=True)


if __name__ == "__main__":
    main()
