"""The benchmark's general generator: one cell of `BENCHMARK.json` built from
its configuration file and its traffic file, run as set-up, a measured
window, an optional profiled window and the check against the plain
reference.

A traffic file's `kind` names the job: the module benchmark/kinds/<kind>.py,
whose `Cell` (a subclass of `Cell` below) runs it; the file's other keys size
it. A job of a new shape is a new kind file; a mix of an existing shape is a
traffic file alone. The kinds:

- "ensemble" (kinds/ensemble.py): an uncertainty engine's predict over
  synthetic frames, one image at a time, at native resolution.
- "train" (kinds/train.py): the trainer's epochs over a device-resident
  split, on one card or under an NCCL mesh.

Every input is made on the device from the seed: the weights (one uniform
draw, scaled per leaf to torch's default bound; GroupNorm ones and zeros),
float32 uniform frames, binary targets tied to the frames (targets_of) and
a circular field of view; the training split holds them as uint8. The
reference gets the same tensors and recomputes everything the program
derives from them.
"""

from __future__ import annotations

import gc
import importlib.util
import math
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import unet as ref

# --- seeds and inputs -------------------------------------------------------------


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed."""
    words = [seed % 2**64] + [zlib.crc32(str(t).encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor} in one uniform draw on the device."""
    specs = ref.param_specs(cfg)
    convs = [(n, s) for n, s, init in specs if init == "conv"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    u = torch.rand(sum(math.prod(s) for _, s in convs), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in convs:
        size = math.prod(shape)
        fan_in = math.prod(shape[1:])
        out[name] = ((u[at:at + size] * 2.0 - 1.0) / math.sqrt(fan_in)).reshape(shape)
        at += size
    for name, shape, init in specs:
        if init != "conv":
            out[name] = torch.full(shape, 1.0 if init == "one" else 0.0, device=device)
    return {n: out[n] for n, _, _ in specs}


def fov(h: int, w: int, device) -> torch.Tensor:
    """A circular field of view, 1 inside (DRIVE's masks are such disks)."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None] - (h - 1) / 2
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :] - (w - 1) / 2
    return ((yy * yy + xx * xx) <= (0.48 * min(h, w)) ** 2).to(torch.float32)


def targets_of(traffic: dict, images: torch.Tensor, gen) -> torch.Tensor:
    """bool (N, H, W, 1) binary targets tied to the images (N, H, W, 1) in
    [0, 1]: frame k's ones are its pixels whose value lies in a band of
    width s_k from u_k, s_k drawn from the traffic's `vessel_share` range
    (as DRIVE's vessel maps cover 4-24% of a frame) and u_k from [0, 1 -
    s_k], so that each frame is a task of its own and a batch's rows pull
    its gradient different ways."""
    n, dev = images.shape[0], images.device
    lo, hi = traffic["vessel_share"]
    share = lo + (hi - lo) * torch.rand((n, 1, 1, 1), generator=gen, device=dev)
    start = (1.0 - share) * torch.rand((n, 1, 1, 1), generator=gen, device=dev)
    return (images >= start) & (images < start + share)


def make_frames(traffic: dict, seed: int, device) -> tuple:
    """(images, targets, masks), float32 (N, H, W, 1)."""
    n, h, w = traffic["frames"], traffic["height"], traffic["width"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "frames"))
    images = torch.rand((n, h, w, 1), generator=gen, device=device)
    targets = targets_of(traffic, images, gen).to(torch.float32)
    masks = fov(h, w, device)[None, :, :, None].expand(n, h, w, 1).contiguous()
    return images, targets, masks


def make_split(traffic: dict, seed: int, device) -> tuple:
    """(images, targets, masks) uint8 (N, H, W, 1), 0/255 for the binary two."""
    n, h, w = traffic["frames"], traffic["height"], traffic["width"]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "split"))
    images = torch.randint(0, 256, (n, h, w, 1), generator=gen, device=device,
                           dtype=torch.uint8)
    targets = targets_of(traffic, images.to(torch.float32) / 255.0, gen).to(torch.uint8) * 255
    masks = (fov(h, w, device) * 255).to(torch.uint8)[None, :, :, None].expand(n, h, w, 1)
    return images, targets, masks.contiguous()


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# --- the comparisons --------------------------------------------------------------


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.to(torch.float64).cpu(), b.to(torch.float64).cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# --- the program ----------------------------------------------------------------


def port_model(cfg: dict, weights: dict, device):
    """The port's UNet of the configuration, holding `weights`."""
    from unet_research_tpu_torch.models.unet import DropBlockConfig, UNet, UNetConfig

    db, ramp = cfg["dropblock"], cfg.get("ramp")
    kw = dict(kind=db["kind"], block_size=db["block_size"], mask_impl=db["mask_impl"])
    if ramp is not None:
        kw.update(use_scheduler=True, start_drop_prob=ramp["start"], max_drop_prob=ramp["stop"],
                  nr_steps=ramp["steps"])
    ucfg = UNetConfig(init_channels=cfg["init_channels"], filters=cfg["filters"],
                      output_channels=cfg["output_channels"], model_depth=cfg["model_depth"],
                      pool_mode=cfg["pool_mode"], up_mode=cfg["up_mode"],
                      connection=cfg["connection"], norm=cfg["norm"],
                      group_norm_groups=cfg["group_norm_groups"], activation=cfg["activation"],
                      dropblock=DropBlockConfig(**kw), remat=cfg["remat"],
                      dtype=getattr(torch, cfg["dtype"]), conv_impl=cfg["conv_impl"])
    with torch.device(device):
        model = UNet(ucfg, device=device)
    model.load_state_dict(weights)
    return model


class Window:
    """What a measured window did: `units` ("image" or "epoch") and the
    seconds of each, the work (member passes or train images, all ranks),
    its wall seconds, the answers attempted and failed."""

    def __init__(self, unit: str):
        self.unit, self.seconds, self.work = unit, [], 0
        self.wall_s = 0.0
        self.attempted = self.failed = 0


class Cell:
    """One cell (module docstring). A kind's Cell defines `unit` ("image" or
    "epoch") and setup(), window(seconds) -> Window, profile_work() -> (run,
    work) (a slice of the window's work for the profiler and its size for
    roofline.expected), release() (drops the program's state), check() ->
    {number: value} (the program's numbers against the reference, after
    release) and control() -> {number: value} (the float8 reference's, in
    the program's place). mesh: this rank's mesh (parallel/mesh.py) of a cell
    on several cards."""

    def __init__(self, workload: dict, config: dict, traffic: dict, seed: int, device,
                 mesh=None):
        self.workload, self.cfg, self.traffic = workload, config, traffic
        self.seed, self.device, self.mesh = seed, torch.device(device), mesh
        self.chips = 1 if mesh is None else mesh.size
        self.on_card = self.device.type == "cuda"
        self.phases, self.last = [], time.perf_counter()  # set-up's phases and seconds

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def phase(self, name: str) -> None:
        """Record the seconds since the last phase of set-up (synchronised)."""
        self.sync()
        now = time.perf_counter()
        self.phases.append((name, now - self.last))
        self.last = now


ROOT = Path(__file__).resolve().parent.parent  # the checkout that holds this file


def kind(name: str, root: Path = ROOT):
    """The `Cell` class of root/benchmark/kinds/<name>.py."""
    path = Path(root) / "benchmark" / "kinds" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_kind_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Cell


def make_cell(workload: dict, config: dict, traffic: dict, seed: int, device, mesh=None,
              root: Path = ROOT) -> Cell:
    """The cell of its traffic's kind, found under root."""
    return kind(traffic["kind"], root)(workload, config, traffic, seed, device, mesh)
