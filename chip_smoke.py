"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the hand-written kernels from unet_research_tpu_torch/ops/cuda/csrc
(and checks that K3's library holds Hopper's warpgroup MMA and TMA loads and
no mma.sync), holds each kernel against its plain PyTorch version at the
shapes of the main path (K3 forward at batch 16 and 1, every main-path K3
launch asserted to run the wgmma kernel; K4's table launch, rotate_fan_table,
bit-equal to its parameter launch on both fans of two chunks; GroupNorm's six
epilogue launches of ops/cuda/group_norm.py at (1, 592, 576, 64),
(1, 37, 36, 1024) and (16, 592, 576, 64), each in its own `kernels` row;
K1's merge mode bit-equal to the four launches it replaces at the canonical
U-Net's four merges, each timed against them, its own `kernels` row), then
runs the
MC-DropBlock ensemble of the canonical 31M U-Net
(bf16, dependent DropBlock b=7 p=0.15, conv_impl='pair' + mask_impl='fused')
on a seeded synthetic 584x565 image and checks its outputs and launch
counts, then `mc-program`: 172 members through the engine's device program
(a CUDA graph of the chunk replayed over the 10 body chunks) against every
chunk from the host, from one seed (launches equal with K1 and K3 credited
per replay, one replay's kernels equal to one eager chunk's, the
statistics within the ensembles' gate; passes/s of both routes, the
replays' idle share, the capture's seconds, both peaks), then the
rotational TTA ensemble of the same model (bf16, DropBlock off,
conv_impl='pair', all 359 angles) under both warps, 'shear' (kernel K4, by
its table launch in the program) and 'gather', and `rotational-program`,
the same comparison under both warps, then `mc-full`: the MC ensemble at
its full size (1000 members on the 584x565 frame, pair+fused, chunk 16,
none saved, five predicts on one engine; K1 1386 (252 of them in its merge
mode, `merge:kernel`, and no `merge:plain`), K3 189, GroupNorm's statistics
and finishing launches 504 each and its apply 252 in each of the last
three, the first call's
capture the one program, replayed by every later call, the statistics
against one eager 1000-member predict from the same seed), the same at
resize 256 (chunk 128), and at 300 members on cuDNN with plain masks and
on pair+fused, each printed with the card's name and power limit (the
benchmark, benchmark/run.py, measures its speed), then training: K3's
backward against the plain route's autograd at the train shapes, batch 1
and 2 (bf16 and float32), one train step through the kernel route against
the plain routes, Trainer.fit of the canonical model
(bf16, remat, dependent DropBlock b=7 ramped 0 -> 0.15 over 8 steps,
pair + kernel masks, SGD lr 1e-3 momentum 0.99 clip 0.5) for 3 epochs of 8
synthetic 584x565 images with its launch counts (scanned epochs: a CUDA
graph of the step replayed over each epoch), and one lr_find sweep, then
`train-scan`: the same fit with the ramp over 12 steps (across the first
epoch boundary), scanned and stepped from the same weights and seed, with
both fits' launches, losses and parameters (within 1e-4 and a tenth of the
fit's own movement), one replay's kernels against one eager step's
(profiler kernel events), an epoch of replays' kernels against the launch
counts it is credited with, the capture's seconds, a replayed and an eager
step's ms, a replayed epoch's idle share (the union of its kernels'
intervals over its wall time), both fits' steps/s and peak memory (the
stepped fit takes every step from the host: Trainer(program=False)), then
`train-step-program`: lr_find's 100-step sweep through its step program (a
CUDA graph of the step, the learning rate read from a table on the card)
against every step from the host, from one set of weights and seed (the
same number of steps, the smoothed losses within 2e-3 relative, the
suggestion within one step of the sweep's grid, equal launches; both
routes' seconds, the capture's seconds, peaks), and a uni fit under a size
plan of -1, 256 and 128 (2 epochs of 24 synthetic 584x565 items, each size
stepped once eagerly first) through one graph per size against the host's
steps (the train-scan tolerances, equal launches, one capture per size,
one replay's kernels those of one eager step at each size; each size's
replayed and eager step ms, both fits' seconds and peaks), then
`eval-program`: the forward programs (a CUDA graph per role and input
shape after one eager warm-up forward) against every forward from the host
(program=False), from one set of weights: Trainer.validate and
Trainer.predict on 8 synthetic 584x565 images under `none` and `lft
-new_size 256`, base_model_mf.predict_at at 128x128, 256x256 and 584x565
(the loss and the outputs within twice the plain bf16 route's distance
from plain float32, 3 K3 launches a forward on both routes), then a fit at
train_batch 2 and val_batch 2 (5 training and 3 validation images, 3
epochs: steps of 2, 2, 1 rows, a graph per (size, rows)) and lr_find's 30
steps at train_batch 2 through the batched step programs (the train-scan
tolerances, lr_find's as train-step-program's, equal launches); replayed
and eager ms per forward and step, capture seconds per shape and peaks
printed; then one-shot evaluation on 6 validation and 20 test images,
base_model_mf.evaluate_at end to end and Trainer.predict's forwards, each
run through a new program against program=False in turn (eager, captured,
captured, eager), with the captures' and the collector's seconds, then data
parallelism on the one card (`dp`): K1/K2 at a sample offset
(8 of 16, 1 of 2) against their plain versions and the full launch's
rows; two gloo ranks sharing the card (parallel/launch.py; NCCL refuses
two ranks on one card) take one train step at a global batch of 2 in
float32 and in bf16 against the one-process steps, compare their
parameters' float64 checksums, run Trainer.fit (1 epoch of 4 images at
train_batch 2, 4 validation images) with each kernel's launches and rank
0's checkpoint, time a step and the gradient all-reduce, and run the
48-member MC engine split over them against the one-process run above;
under gloo the steps and the MC chunks take the program's table route
eagerly (no graph: gloo's collectives run on the host) and the validation
forward is captured, which the phase asserts; then NCCL at world size 1
(`dp-nccl`): the data-parallel step bit-equal to the plain step, then the
mesh programs captured under NCCL: eval-program's batched fit (3 epochs of
5 images at train_batch 2, so a partial batch with a graph of its own) and
its 30-step lr_find through the mesh step program against program=False
under the mesh and against eval-program's mesh-less captured run (the
train-scan and train-step-program tolerances, equal launches, the psums
and the gradient all-reduce in every captured step's counts),
Trainer.validate and Trainer.predict under the mesh against both (the
eval-program gates), and the 172-member MC engine under the mesh (its
chunk and all_gather in one graph) against its host route and the
mesh-less engine (the ensembles' gate); it prints the captures' decision,
the replayed and eager step and chunk ms, the capture seconds and the
peaks; then the CLIs: on a synthetic augmented tree of 584x565 PNGs (train 4, val
2, test 1; written under _runs/chip_smoke_cli/ and deleted at the end) it
runs, through their main(argv), `training -mode train` (1 epoch, bf16,
default routes), `training -mode test` on the kept checkpoint,
`dropblock_uncertainty` (48 members, chunk 16, 4 saved) and
`rotational_uncertainty -warp shear` (359 angles, 2 saved), and checks
each command's launch counts, its output tree file for file, the .pt
shapes, finite metrics and that the checkpoint loads back; it times each
command, the share spent outside the engines, and the evaluation layer's
host work. Then dataset generation (`drive-augment`): a synthetic DRIVE tree
at 584x565 (5 training images as uncompressed RGB TIFF with GIF masks and
1st_manual GIFs whose LZW codes stay at 9 bits, 2 test images; under
_runs/chip_smoke_drive/, deleted at the end) read back equal through
load_drive, one 36-member `_augment_batch` on the card held against the
CPU's under the tie rule of tests/test_torch_augment.py (tie counts and
seconds printed), and `create_augmentations -num_train 8` through its
main(argv) with its tree asserted (24 train triples, 2 val, test 01_ and
02_) and its device-batch and PNG-write seconds apart. Then the
multi-fidelity CLIs (`mf-cli`) on that tree: K3 and its dx at 32^2, 128^2,
256^2 and 304x208 against the plain version and one model forward at
300x200 (3 K3 launches), then `mf_training -policy uni -orig_train_size 3
-num_augmentations 8` (its size plan holds -1, 256 and 128), `lf_training
-policy lft -new_size 256` in train and test mode, and `base_model_mf` on
the MF checkpoint at 128x128, 256x256 and 584x565, each at full width
(bf16, default routes, 1 epoch) with its launch counts, every K3 launch on
wgmma, its output tree, `.pt` shapes, finite metrics, the checkpoint read
back, and its seconds and share outside the engines. Then the analysis
half (`matrix`): `run_matrix -stage all --with_dependent` on BM-1, MF-1 and
LF-3 through its main(argv) on the generated tree at full width (bf16,
default routes, `-warp shear` passed through; LF-3 trains at 128^2 and its
uncertainty runs at `-resize 128`), each command's launches asserted (K2,
K3, dx and fold per train, K3 per test, K1 per MC run, K4 per rotational
run, every K3 on wgmma), every stage's output tree and the density
report's files (kinds std, cv, hist, did) asserted, the density stage's
seconds split into the KDE (on the card), np.histogram and PNG writes;
`view_tensors` on the same out_root; a rerun that skips every stage; then
`epoch-time`: scripts/epoch_time_torch.py's arms (-conv_impl xla and pair,
2 epochs each) on the generated tree, with their launches. Then
`density-scale`: the density report (std, cv, hist) from memory at a real
study's size, 12 models x 6 validation images x 584x565 for DB and ROT
(seeded synthetic maps, no files read), its seconds split the same way and
the KDE's peak extra device memory (at most 1 GiB), and the card's KDE on
a 200k-sample subset held against the dense float64 formula on the CPU
(1e-9 of the curve's maximum). Then `transunet`: TransUNet R50-ViT-B/16
(models/transunet.py) at its published widths in bf16 on the 584x565 frame,
one eager forward of 16 members with DropBlock on and its CUDA graph
replayed bit-equal, with their launches asserted (K1 at the 45 sites,
GroupNorm's statistics and epilogue kernels, 12 flash attention calls, no
`attn:other`, `gn:plain` or `bn:plain`), a forward with DropBlock off, the
same forward with each site's K1 and GroupNorm launches held to their
plain versions on its own inputs (keep counts exact) and against the plain
routes in bf16 and float32 (within twice the bf16 route's noise), K1 and
gn_apply timed at an odd-size stage-1 site and a 16-channel decoder site
(`kernels` rows), the
MC-DropBlock (48 members) and rotational (32) engines and three scanned
train steps (remat, train-mode BatchNorm, the mask producer), with their
ms, members/s and peaks (`python3 chip_smoke.py transunet` runs the build
and that phase alone; `python3 chip_smoke.py k1-merge` the build and the
check of K1's merge mode). Last, `eval-program`'s `failed-capture`
part: a capture that the card refuses (a host read inside the validation
forward) raises out of Trainer.validate; it runs last because PyTorch's
caching allocator keeps every later free of the process after a failed
capture. An early `env` line
says which of PIL, pandas, sklearn, matplotlib and msgpack import here;
the port needs none of them.
Every phase prints one JSON line; the last line is
{"ok": true, "device": {...}}. Any failure raises (non-zero exit). Needs
one CUDA card; exits non-zero without one.

Ensemble programs: the captured route's mean, std and saved members within
twice the plain bf16 route's distance from float32 of the eager route's
(the same masks or angles; K3's float32 atomics part them), K4's table
launch bit-equal to the parameter launch.
Every launch count asserted counts GroupNorm's epilogue launches too
(`epilogue`: per forward and backward of the canonical model); every plain
route runs GroupNorm on its plain ops (`plain_epilogue`: none of the
epilogue's kernels, and `gn:plain` sites), so the bf16 noise that gates the
kernel routes is plain PyTorch's.
Tolerances: masks and keep counts exact (one counter hash on both sides;
K2 reading its threshold from a device word too, against the scalar launch
and the plain version at the thresholds of a ramp);
K1 outputs within 2 bf16 ulps; K3 max |y - plain| / max |plain| <= 1e-2 in
bf16, and the moment sums within 1e-3 of the plain version's float32 sums
relative to their largest magnitude (float32 atomics in run-dependent
order; TF32 is off for every float32 reference); K4 bit-equal to its plain
version (the same float32 operations in the same order), one kernel launch
per call per 128 members, and a peak allocation of at most its output plus
1 MiB; for each ensemble, the kernel route's probability map within
twice the plain bf16 route's distance from the plain float32 route, on the
same chunk (and site keys). K3 backward: dx and dK within 1e-2 (bf16) and
1e-3 (float32, TF32 off) of the plain route's, relative to their largest
magnitude, with nonzero cotangents on the sums; the fold kernel's g within
one bf16 rounding of its plain version (bit-equal expected); the bf16
dK within 4e-3 of the float32 correlation of the same x and folded
cotangent (one rounding to bf16 is at most 2^-9 of the largest magnitude).
GroupNorm's epilogue: its partial sums and finishing launches within 1e-5
of their plain versions on the same inputs, relative to the largest
magnitude; the apply and both dx passes bit-equal. One train step: the kernel
route's loss and gradient (global relative L2 over all parameters) within
twice the plain bf16 route's distance from the plain float32 route.
Scanned against stepped fit: epoch losses within 2e-3 relative and the
parameters' relative L2 within 2e-3 (JAX's own scan-against-step
tolerance: K3's float32 atomics and cuDNN's wgrad may order sums
differently in two runs, and the scanned update rounds p - lr * v once
more), equal launches per kernel, one replay's kernels equal by name and
number to one eager step's. The step programs against the host's steps:
the same tolerances, and lr_find's smoothed losses within 2e-3 relative
and its suggestion within one step of its grid.
Data parallelism: K1/K2 at an offset bit-equal; the float32 step's loss
within 2e-5 relative and parameters within rtol 2e-4 / atol 2e-6 of the
one-process step (tests/test_mesh.py's); the bf16 update (relative L2)
within twice the plain bf16 route's distance from plain float32; the
ranks' checksums equal; the split MC run's mean, std and saved members
within twice the plain bf16 route's distance from float32 of the
one-process run (the masks are the same bits); NCCL at world size 1
bit-equal to the plain step (cuDNN deterministic, cuDNN convs), and its
captured mesh programs within the tolerances of the phases whose runs
they repeat (train-scan's for the fit, train-step-program's for lr_find,
eval-program's for the forwards, the ensembles' gate for the MC engine).
"""

from __future__ import annotations

import collections
import contextlib
import csv
import gc
import inspect
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is false")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))

import epoch_time_torch  # noqa: E402
from benchmark import tracing  # noqa: E402
from benchmark.roofline import PEAK_BYTES, PEAK_FLOPS, bound, power_limit  # noqa: E402
from unet_research_tpu_torch.cli import base_model_mf as cli_base_model_mf  # noqa: E402
from unet_research_tpu_torch.cli import common as cli_common  # noqa: E402
from unet_research_tpu_torch.cli import create_augmentations as cli_augment  # noqa: E402
from unet_research_tpu_torch.cli import dropblock_uncertainty as cli_dropblock  # noqa: E402
from unet_research_tpu_torch.cli import lf_training as cli_lf  # noqa: E402
from unet_research_tpu_torch.cli import mf_training as cli_mf  # noqa: E402
from unet_research_tpu_torch.cli import rotational_uncertainty as cli_rotational  # noqa: E402
from unet_research_tpu_torch.cli import run_matrix as cli_run_matrix  # noqa: E402
from unet_research_tpu_torch.cli import training as cli_training  # noqa: E402
from unet_research_tpu_torch.cli import view_tensors as cli_view_tensors  # noqa: E402
from unet_research_tpu_torch.evaluation import artifacts as ev_artifacts  # noqa: E402
from unet_research_tpu_torch.evaluation import density as ev_density  # noqa: E402
from unet_research_tpu_torch.evaluation import metrics as ev_metrics  # noqa: E402
from unet_research_tpu_torch.models import sites as tsites  # noqa: E402
from unet_research_tpu_torch.models import unet as tunet  # noqa: E402
from unet_research_tpu_torch.ops.cuda import build  # noqa: E402
from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk  # noqa: E402
from unet_research_tpu_torch.ops.cuda import group_norm as gnk  # noqa: E402
from unet_research_tpu_torch.ops.cuda import launches as cuda_launches  # noqa: E402
from unet_research_tpu_torch.ops.cuda import pair_conv as pc  # noqa: E402
from unet_research_tpu_torch.ops.cuda import shear_rotate as sr  # noqa: E402
from unet_research_tpu_torch.ops.cuda import upsample as upk  # noqa: E402
from unet_research_tpu_torch.data import ArrayDataset, load_drive, load_split  # noqa: E402
from unet_research_tpu_torch.data.loading import shard_batch  # noqa: E402
from unet_research_tpu_torch.parallel import launch  # noqa: E402
from unet_research_tpu_torch.parallel.mesh import (  # noqa: E402
    all_gather,
    all_reduce_grads_,
    make_mesh,
    multihost_initialize,
)
from unet_research_tpu_torch.data import augment as data_augment  # noqa: E402
from unet_research_tpu_torch.ops.losses import masked_rescaled_bce  # noqa: E402
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig, lr_find  # noqa: E402
from unet_research_tpu_torch.train import lf_policy  # noqa: E402
from unet_research_tpu_torch.train import loop as tloop  # noqa: E402
from unet_research_tpu_torch.train import make_size_plan  # noqa: E402
from unet_research_tpu_torch.train.loop import drop_prob_at  # noqa: E402
from unet_research_tpu_torch.ops.dropblock import (  # noqa: E402
    dropblock_gamma_dependent,
    dropblock_gamma_independent,
)
from unet_research_tpu_torch.ops.image import (  # noqa: E402
    resize_bilinear,
    rotate_bilinear,
    square_pad,
)
from unet_research_tpu_torch.uncertainty.ensemble import chunk_layout  # noqa: E402
from unet_research_tpu_torch.uncertainty.mc_dropblock import MCDropBlockEngine  # noqa: E402
from unet_research_tpu_torch.uncertainty.rotational import RotationalEngine  # noqa: E402
from unet_research_tpu_torch.train.checkpoint import find_checkpoint  # noqa: E402
from unet_research_tpu_torch.utils.convert import load_model_checkpoint  # noqa: E402
from unet_research_tpu_torch.utils.general import to_u8  # noqa: E402
from unet_research_tpu_torch.utils import png  # noqa: E402

DEV = torch.device("cuda")
ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 592, 576                # 584x565 autopadded to a multiple of 16
CHUNK = 16
P_DROP, BLOCK = 0.15, 7
GAMMA = dropblock_gamma_dependent(H, W, BLOCK, P_DROP)
COUNTERS = {"dropblock_fused_apply": dbk.dropblock_fused_apply,
            "dropblock_mask": dbk.dropblock_mask,
            "conv3x3_pair": pc.conv3x3_pair,
            "conv3x3_pair_dx": pc.conv3x3_pair_dx,
            "conv3x3_pair_fold": pc.conv3x3_pair_fold,
            "rotate_fan": sr.rotate_fan,
            "rotate_fan_table": sr.rotate_fan_table,
            **{fn.__name__: fn for fn in gnk.WRAPPERS},
            "upsample_concat": upk.upsample_concat}
# GroupNorm's epilogue in the canonical U-Net: 26 GroupNorm sites, 3 of them
# (K3's, at level 0) given K3's sums under conv_impl='pair'; beside K1
# (mask_impl='fused') only the 4 upconv and the 4 pool norms take the
# epilogue's statistics, and only the pool norms its apply: each upconv norm's
# apply is in K1's merge mode, one launch at each of the 4 skip merges
GN_SITES, GN_K3_SITES, GN_K1_SIDE_SITES, GN_K1_APPLY_SITES, U_MERGES = 26, 3, 8, 4, 4
# one chunk of the rotational fan, the four ties 45 + 90k included
FAN = torch.tensor([45.0, 135.0, 225.0, 315.0, 1.0, 17.0, 33.0, 60.0, 90.0, 101.0, 180.0,
                    200.5, 270.0, 300.0, 333.0, 359.0])


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    for path in pc.path_launches:
        pc.path_launches[path] = 0


def assert_wgmma(where: str) -> None:
    """Every K3 launch since the last reset, forward and dx, ran the
    warpgroup-MMA kernel."""
    k3 = pc.conv3x3_pair.launches + pc.conv3x3_pair_dx.launches
    if pc.path_launches != {"wgmma": k3, "cuda_cores": 0}:
        raise AssertionError(f"{where}: K3 launches by kernel {pc.path_launches} of {k3}")


def counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def epilogue(forwards: int = 0, steps: int = 0, k1_forwards: int = 0, k3: bool = True) -> dict:
    """GroupNorm's epilogue launches (ops/cuda/group_norm.py) of the
    canonical U-Net in bf16: `forwards` forwards through its 26 GroupNorm
    sites, statistics at each but the 3 that take K3's sums (`k3`:
    conv_impl='pair'); `k1_forwards` forwards beside K1 (the 8 upconv and
    pool norms' statistics, the pool norms' apply); `steps` backwards
    through the 26 sites, the dx pass at each that computed its statistics. A train step
    under remat is two forwards and one backward."""
    own = GN_SITES - (GN_K3_SITES if k3 else 0)
    side = GN_K1_SIDE_SITES * k1_forwards
    return {"gn_stats": own * forwards + side, "gn_stats_finish": GN_SITES * forwards + side,
            "gn_apply": GN_SITES * forwards + GN_K1_APPLY_SITES * k1_forwards,
            "gn_grad_sums": GN_SITES * steps,
            "gn_grad_finish": GN_SITES * steps, "gn_grad_dx": own * steps}


@contextlib.contextmanager
def plain_epilogue(where: str):
    """While active, every GroupNorm site runs the plain ops
    (models/sites.py asks `group_norm_act_supported`, refused here): the
    plain routes that the kernel routes are held against run none of
    GroupNorm's kernels. On exit, asserts that none launched and that card
    sites took the plain ops (`gn:plain`)."""
    gate = tsites.group_norm_act_supported
    before = {fn.__name__: fn.launches for fn in gnk.WRAPPERS}
    plain = cuda_launches.HOST["gn:plain"]
    tsites.group_norm_act_supported = lambda *args: False
    try:
        yield
    finally:
        tsites.group_norm_act_supported = gate
    ran = {fn.__name__: fn.launches - before[fn.__name__] for fn in gnk.WRAPPERS}
    sites = cuda_launches.HOST["gn:plain"] - plain
    if any(ran.values()) or sites <= 0:
        raise AssertionError(f"{where}: the plain route launched {ran} of GroupNorm's kernels, "
                             f"{sites} sites on the plain ops")


def route_epilogue(route: str, where: str):
    """plain_epilogue for a plain route (its name starts with 'plain'), else
    nothing."""
    return plain_epilogue(where) if route.startswith("plain") else contextlib.nullcontext()


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


def device_ms(fn, iters: int = 5) -> float:
    """Device time per call from torch.profiler: the summed time of the
    kernels fn launches. For a wrapper whose host work per call (K4's
    per-member scalars) is about as long as its kernels, where time_ms
    would measure the host."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.device_time for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / 1e3 / iters


def bound_ms(bytes_moved: float, flops: float = 0.0):
    """The launch's bound in ms (benchmark/roofline.py) and the side that
    bounds it."""
    by = "bytes" if bytes_moved / PEAK_BYTES >= flops / PEAK_FLOPS else "operations"
    return bound(bytes_moved, flops) * 1e3, by


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place between a and b."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def header() -> None:
    print(f"{power_limit()} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)


def build_kernels() -> None:
    """nvcc of every source, in parallel; ptxas's register, spill and
    warning lines; the counts of Hopper's warpgroup MMA (HGMMA), the older
    mma.sync (HMMA) and TMA loads (UTMALDG) in K3's SASS."""
    t0 = time.perf_counter()
    done = build.build()
    seconds = time.perf_counter() - t0
    usage = {name: [line.strip() for line in info["log"].splitlines()
                    if "registers" in line or "spill" in line or "arning" in line]
             for name, info in done.items()}
    code = build.sass("pair_conv")
    ops = {op: len(re.findall(rf"\b{op}\b", code)) for op in ("HGMMA", "HMMA", "UTMALDG")}
    emit({"phase": "build", "seconds": seconds, "compiled": sorted(done), "ptxas": usage,
          "pair_conv_sass": ops})
    if not (ops["HGMMA"] and ops["UTMALDG"]) or ops["HMMA"]:
        raise AssertionError(f"libpair_conv SASS {ops}: expected HGMMA and UTMALDG, no HMMA")


def keys(seed: int) -> torch.Tensor:
    return tunet.draw_site_keys(1, torch.Generator().manual_seed(seed))[0].to(DEV)


def gn_ab(x: torch.Tensor, groups: int = 32) -> torch.Tensor:
    g = torch.Generator(device=DEV).manual_seed(1)
    c = x.shape[-1]
    scale = 1.0 + 0.1 * torch.randn(c, device=DEV, generator=g)
    bias = 0.1 * torch.randn(c, device=DEV, generator=g)
    a, b = tunet.group_norm_coeffs(x, scale, bias, groups, 1e-5)
    return torch.stack([a, b]).contiguous()


def activation(n: int, c: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn((n, H, W, c), device=DEV, generator=g).to(torch.bfloat16)


def check_k1() -> dict:
    worst = 0
    for c, with_ab, act in ((64, True, "relu"), (128, False, "none")):
        x = activation(2, c, seed=c)
        ab = gn_ab(x) if with_ab else None
        key = keys(c)
        out, keep = dbk.dropblock_fused_apply(x, ab, key, GAMMA, BLOCK, act)
        ref, ref_keep = dbk.dropblock_fused_apply_plain(x, ab, key, GAMMA, BLOCK, act)
        torch.cuda.synchronize()
        ulps = bf16_ulps(out, ref)
        if not torch.equal(keep, ref_keep) or ulps > 2:
            raise AssertionError(f"K1 {tuple(x.shape)}: keep {keep.tolist()} vs "
                                 f"{ref_keep.tolist()}, {ulps} ulps")
        worst = max(worst, float((out.float() - ref.float()).abs().max()))
        emit({"phase": "K1", "shape": list(x.shape), "affine": with_ab, "act": act,
              "max_ulps": ulps, "keep_exact": True})
    x = activation(CHUNK, 64, seed=3)
    ab, key = gn_ab(x), keys(3)
    out, keep = dbk.dropblock_fused_apply(x, ab, key, GAMMA, BLOCK)
    ref, ref_keep = dbk.dropblock_fused_apply_plain(x, ab, key, GAMMA, BLOCK)
    ulps = bf16_ulps(out, ref)
    if not torch.equal(keep, ref_keep) or ulps > 2:
        raise AssertionError(f"K1 {tuple(x.shape)}: keep differs or {ulps} ulps")
    emit({"phase": "K1", "shape": list(x.shape), "affine": True, "act": "relu",
          "max_ulps": ulps, "keep_exact": True})
    worst = max(worst, float((out.float() - ref.float()).abs().max()))
    del out, ref
    ms = time_ms(lambda: dbk.dropblock_fused_apply(x, ab, key, GAMMA, BLOCK), 10)
    plain = time_ms(lambda: dbk.dropblock_fused_apply_plain(x, ab, key, GAMMA, BLOCK), 3, 1)
    bound, by = bound_ms(2 * x.numel() * x.element_size() + ab.numel() * 4)
    row = {"name": "dropblock_fused_apply", "route": "cuda",
           "source": "unet_research_tpu_torch/ops/cuda/csrc/dropblock.cu",
           "replaces": "unet_research_tpu/ops/pallas/dropblock_kernel.py:291",
           "shape": list(x.shape), "max_abs_err": worst, "ms": ms, "plain_ms": plain,
           "bound_ms": bound, "bound_by": by, "library_ms": None}
    emit({"phase": "K1-time", **row})
    return row


# the canonical U-Net's four skip merges at chunk 16, (n, h, w, C1, C2)
MERGE_SHAPES = ((CHUNK, 74, 72, 512, 512), (CHUNK, 148, 144, 256, 256),
                (CHUNK, 296, 288, 128, 128), (CHUNK, H, W, 64, 64))


def merge_composition(x, ab, skip, scale, key, gamma):
    """The four launches K1's merge mode replaces: gn_apply with ReLU, the
    skip's deferred scale as a bf16 multiply, torch.cat, K1's bare site."""
    y = gnk.gn_apply(x, ab, act="relu")
    skip = skip * scale.to(skip.dtype)[:, None, None, None]
    return dbk.dropblock_fused_apply(torch.cat([y, skip], dim=-1), None, key, gamma, BLOCK,
                                     "none")


def check_k1_merge() -> dict:
    """K1's merge mode (dropblock_merge_apply) at MERGE_SHAPES: values and
    keep counts bit-equal to merge_composition on the same inputs (the up
    half's coefficients from gn_stats + gn_stats_finish of x, a per-sample
    scale), then both timed: event ms a call, profiler device ms, the byte
    bound (K1's at C1 + C2 channels) and its share. Returns the kernels row
    (the top merge's timing, the others by shape)."""
    row = {"name": "dropblock_merge_apply", "route": "cuda",
           "source": "unet_research_tpu_torch/ops/cuda/csrc/dropblock.cu",
           "replaces": "none: XLA fuses the JAX model's merge (models/unet.py:784-786)",
           "library_ms": None}
    for shape in MERGE_SHAPES:
        n, h, w, c1, c2 = shape
        g = torch.Generator(device=DEV).manual_seed(c1)
        x = (1.5 * torch.randn((n, h, w, c1), device=DEV, generator=g) + 0.3).to(torch.bfloat16)
        skip = torch.relu(torch.randn((n, h, w, c2), device=DEV, generator=g)).to(torch.bfloat16)
        weight = 1.0 + 0.2 * torch.randn(c1, device=DEV, generator=g)
        bias = 0.2 * torch.randn(c1, device=DEV, generator=g)
        part = gnk.gn_stats(x)
        ab, _ = gnk.gn_stats_finish(part[0], part[1], h * w, weight, bias, GN_GROUPS, 1e-5)
        scale = 1.0 + 0.3 * torch.rand(n, device=DEV, generator=g)
        key, gamma = keys(c1), dropblock_gamma_dependent(h, w, BLOCK, P_DROP)

        def merge():
            return dbk.dropblock_merge_apply(x, ab, skip, scale, key, gamma, BLOCK)

        def plain():
            return merge_composition(x, ab, skip, scale, key, gamma)

        (out, keep), (ref, ref_keep) = merge(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(keep, ref_keep)):
            raise AssertionError(f"K1 merge {shape}: not bit-equal to the composition "
                                 f"({bf16_ulps(out, ref)} ulps, keep {keep.tolist()} vs "
                                 f"{ref_keep.tolist()})")
        del out, ref
        bound, by = bound_ms(2 * n * h * w * (c1 + c2) * 2 + ab.numel() * 4 + n * 12)
        timing = {"shape": list(shape), "bit_equal": True, "ms": time_ms(merge, 10),
                  "device_ms": device_ms(merge), "plain_ms": time_ms(plain, 10),
                  "plain_device_ms": device_ms(plain), "bound_ms": bound, "bound_by": by}
        timing["bound_share"] = bound / timing["device_ms"]
        emit({"phase": "K1-merge", "card": power_limit(), **timing})
        if shape == MERGE_SHAPES[-1]:
            row.update(timing)
        else:
            row["x".join(map(str, shape))] = timing
        del x, skip, part, ab
    return row


def check_k2() -> dict:
    shape = (2, H, W, 64)
    key = keys(7)
    mask, keep = dbk.dropblock_mask(shape, key, GAMMA, BLOCK)
    ref, ref_keep = dbk.dropblock_mask_plain(shape, key, GAMMA, BLOCK)
    torch.cuda.synchronize()
    if not (torch.equal(mask, ref) and torch.equal(keep, ref_keep)):
        raise AssertionError("K2: mask or keep counts differ from the plain version")
    emit({"phase": "K2", "shape": list(shape), "mask_exact": True, "keep_exact": True,
          "keep_fraction": (keep / (H * W * 64)).tolist()})
    shape = (CHUNK, H, W, 64)
    mask, keep = dbk.dropblock_mask(shape, key, GAMMA, BLOCK)
    ref, ref_keep = dbk.dropblock_mask_plain(shape, key, GAMMA, BLOCK)
    if not (torch.equal(mask, ref) and torch.equal(keep, ref_keep)):
        raise AssertionError(f"K2 {shape}: mask or keep counts differ from the plain version")
    emit({"phase": "K2", "shape": list(shape), "mask_exact": True, "keep_exact": True})
    del mask, ref
    # the threshold as a device word, computed on the card from the drop
    # probability as a train step computes it: equal to the host's number at
    # every site size of the canonical model and both gamma functions along
    # a ramp, then K2 given it, at the drop probabilities of a ramp 0 ->
    # P_DROP over 8 steps, at the training shape of the top site and at
    # batch 2
    ramp = tunet.DropBlockConfig(start_drop_prob=0.0, max_drop_prob=P_DROP, nr_steps=8)

    def device_word(gamma_fn, h, w, step):
        dp = torch.full((), float(drop_prob_at(step, ramp)), dtype=torch.float32, device=DEV)
        return dbk.seed_threshold(gamma_fn(h, w, BLOCK, dp))

    for gamma_fn in (dropblock_gamma_dependent, dropblock_gamma_independent):
        for level in range(5):
            h, w = H >> level, W >> level
            for step in range(10):
                host = dbk.seed_threshold(gamma_fn(h, w, BLOCK, drop_prob_at(step, ramp)))
                if int(device_word(gamma_fn, h, w, step)) != host:
                    raise AssertionError(f"{gamma_fn.__name__} at {h}x{w}, step {step}: the "
                                         "card's seed threshold differs from the host's")
    checked = []
    for n in (1, 2):
        for step in (0, 1, 4, 7, 9):
            gamma = dropblock_gamma_dependent(H, W, BLOCK, drop_prob_at(step, ramp))
            thr = device_word(dropblock_gamma_dependent, H, W, step)
            got = dbk.dropblock_mask((n, H, W, 64), key, None, BLOCK, threshold=thr)
            scalar = dbk.dropblock_mask((n, H, W, 64), key, gamma, BLOCK)
            plain = dbk.dropblock_mask_plain((n, H, W, 64), key, gamma, BLOCK)
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(got, scalar, plain)):
                raise AssertionError(f"K2 with a device threshold at step {step}, batch {n}: "
                                     "mask or keep counts differ from the scalar launch or "
                                     "the plain version")
            checked.append([n, step, int(thr)])
    emit({"phase": "K2-threshold", "checked": checked, "mask_exact": True, "keep_exact": True})
    thr = torch.tensor(dbk.seed_threshold(GAMMA), dtype=torch.int64, device=DEV)
    threshold_ms = time_ms(lambda: dbk.dropblock_mask(shape, key, None, BLOCK, threshold=thr), 10)
    ms = time_ms(lambda: dbk.dropblock_mask(shape, key, GAMMA, BLOCK), 10)
    plain = time_ms(lambda: dbk.dropblock_mask_plain(shape, key, GAMMA, BLOCK), 3, 1)
    bound, by = bound_ms(float(np.prod(shape)))
    row = {"name": "dropblock_mask", "route": "cuda",
           "source": "unet_research_tpu_torch/ops/cuda/csrc/dropblock.cu",
           "replaces": "unet_research_tpu/ops/pallas/dropblock_kernel.py:347",
           "shape": list(shape), "max_abs_err": 0.0, "ms": ms, "threshold_ms": threshold_ms,
           "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": None}
    emit({"phase": "K2-time", **row})
    return row


def conv_weights(cin: int, cout: int) -> torch.Tensor:
    g = torch.Generator(device=DEV).manual_seed(cin)
    bound = 1.0 / (9 * cin) ** 0.5
    return ((torch.rand((3, 3, cin, cout), device=DEV, generator=g) * 2 - 1) * bound).to(torch.bfloat16)


def library_conv(x, w):
    """F.conv2d + the two float32 sums: a yardstick, not used by the port."""
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    y32 = y.float()
    return y, y32.sum(dim=(2, 3)), (y32 * y32).sum(dim=(2, 3))


def check_k3() -> dict:
    """K3 forward at the main-path shapes, batch 16 (an ensemble chunk) and
    batch 1 (training), against the plain version; timed beside one cuDNN
    conv in bf16 with channels-last weights (library_ms) and that conv with
    the float32 sums (library_with_sums_ms); batch 1 also in device time."""
    worst, row = 0.0, None
    for cin in (64, 128):
        w = conv_weights(cin, 64)
        w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        for n in (CHUNK, 1):
            x = activation(n, cin, seed=cin + n)
            y, s1, s2 = pc.conv3x3_pair(x, w, stats=True)
            if pc.conv3x3_pair.path != "wgmma":
                raise AssertionError(f"K3 took {pc.conv3x3_pair.path} at a main-path shape")
            ry = pc.conv3x3_pair_plain(x, w)
            # the kernel's sums come from its float32 accumulator: hold them
            # against the plain version run in float32 on the same values
            _, r1, r2 = pc.conv3x3_pair_plain(x.float(), w.float(), stats=True)
            torch.cuda.synchronize()
            y_rel = float((y.float() - ry.float()).abs().max() / ry.float().abs().max())
            s_rel = max(float((s - r).abs().max() / r.abs().max()) for s, r in ((s1, r1), (s2, r2)))
            if y_rel > 1e-2 or s_rel > 1e-3:
                raise AssertionError(f"K3 {tuple(x.shape)}->64: y rel {y_rel}, sums rel {s_rel}")
            emit({"phase": "K3", "shape": list(x.shape), "cout": 64, "path": "wgmma",
                  "y_max_rel": y_rel, "sums_max_rel": s_rel})
            worst = max(worst, float((y.float() - ry.float()).abs().max()))
            del y, ry, r1, r2
            x_nchw = x.permute(0, 3, 1, 2)
            iters = 5 if n > 1 else 20
            timing = {"shape": list(x.shape), "cout": 64,
                      "ms": time_ms(lambda: pc.conv3x3_pair(x, w, stats=True), iters),
                      "plain_ms": time_ms(lambda: pc.conv3x3_pair_plain(x, w, stats=True), iters)}
            timing["bound_ms"], timing["bound_by"] = bound_ms(
                x.numel() * 2 + n * H * W * 64 * 2 + w.numel() * 2, 2.0 * 9 * cin * 64 * n * H * W)
            timing["library_ms"] = time_ms(
                lambda: torch.nn.functional.conv2d(x_nchw, w_lib, padding=1), iters)
            timing["library_with_sums_ms"] = time_ms(lambda: library_conv(x, w_lib), iters)
            if n == 1:
                timing["device_ms"] = device_ms(lambda: pc.conv3x3_pair(x, w, stats=True), 20)
                timing["library_device_ms"] = device_ms(
                    lambda: torch.nn.functional.conv2d(x_nchw, w_lib, padding=1), 20)
            emit({"phase": "K3-time", **timing})
            if cin == 64 and n == CHUNK:
                row = {"name": "conv3x3_pair", "route": "cuda",
                       "source": "unet_research_tpu_torch/ops/cuda/csrc/pair_conv.cu",
                       "replaces": "unet_research_tpu/ops/pallas/pair_conv.py:234", **timing}
            else:
                row[f"{cin}_to_64_batch_{n}"] = timing
    row["max_abs_err"] = worst
    return row


def kernels_per_call(fn) -> list[str]:
    """The names of the device operations one call of fn launches, from a
    marked profiler window (`window`)."""
    return [name for name, _, _ in window(fn).ops]


def peak_rise(fn) -> tuple[int, torch.Tensor]:
    """How far one call of fn raises the peak of allocated device memory
    above what was allocated before it, and its result."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before, out


def check_k4() -> dict:
    """K4 on both fans of the rotational chunk: bit-equal to its plain
    version, one kernel launch per call per 128 members (also at 130
    members), and a peak allocation of its output plus at most 1 MiB (no
    (K, S, S) intermediate); then its times."""
    im = torch.as_tensor(synthetic_image()[0], device=DEV)
    g = torch.Generator(device=DEV).manual_seed(4)
    segs = torch.rand((len(FAN), 584, 565, 1), device=DEV, generator=g)
    fans = {"forward": (im, FAN), "inverse": (segs, -FAN),
            "forward_130": (im, torch.arange(130, dtype=torch.float32) * 2.75 + 0.5)}
    row = None
    for name, (img, angles) in fans.items():
        rise, out = peak_rise(lambda: sr.rotate_fan(img, angles))
        want = -(-len(angles) // 128)
        kernels, _ = settled(lambda: kernels_per_call(lambda: sr.rotate_fan(img, angles)),
                             lambda ks: len(ks) == want)
        if len(kernels) != want or not all("shear_fan_kernel" in k for k in kernels):
            raise AssertionError(f"K4 {name} fan: kernels {kernels}, expected {want} launch(es)")
        if rise > out.numel() * 4 + 2**20:
            raise AssertionError(f"K4 {name} fan: peak allocation rose {rise} bytes for a "
                                 f"{out.numel() * 4}-byte output")
        check = {"phase": "K4", "fan": name, "shape": list(img.shape), "members": len(angles),
                 "kernel_launches": len(kernels), "peak_rise_bytes": rise,
                 "output_bytes": out.numel() * 4}
        if name != "forward_130":
            ref = sr.rotate_fan_plain(img, angles)
            if out.shape != ref.shape or not torch.equal(out, ref):
                err = float((out - ref).abs().max()) if out.shape == ref.shape else None
                raise AssertionError(f"K4 {name} fan differs from the plain version: {err}")
            check.update(angles=angles.tolist(), bit_equal=True,
                         quarter_turns=sr.fan_params(angles, 584, 565).qm.tolist())
        emit(check)
    del out
    for name, (img, angles) in list(fans.items())[:2]:
        ms = device_ms(lambda: sr.rotate_fan(img, angles))
        call_ms = time_ms(lambda: sr.rotate_fan(img, angles), 20)
        plain = time_ms(lambda: sr.rotate_fan_plain(img, angles), 3, 1)
        on_card = angles.to(DEV)  # as the engine holds them for the gather warp
        gather = time_ms(lambda: rotate_bilinear(img, on_card), 5)
        # each input read once, each output written once, and the (K, 5) scalars
        bound, by = bound_ms(4 * (img.numel() + len(angles) * 584 * 565 + 5 * len(angles)))
        timing = {"shape": list(img.shape), "angles": len(angles), "ms": ms,
                  "call_ms": call_ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                  "library_ms": None, "gather_ms": gather}
        emit({"phase": "K4-time", "fan": name, **timing})
        if row is None:
            row = {"name": "rotate_fan", "route": "cuda",
                   "source": "unet_research_tpu_torch/ops/cuda/csrc/shear_rotate.cu",
                   "replaces": "unet_research_tpu/ops/pallas/shear_rotate.py:147", **timing}
        else:
            row["inverse_fan"] = timing
    row["max_abs_err"] = 0.0
    return row


def check_k4_table() -> dict:
    """K4's table launch (rotate_fan_table) on both fans of two chunks, the
    rows at a chunk index on the card: bit-equal to the parameter launch
    (rotate_fan) of that chunk's angles and to its plain version, one
    shear_fan_table_kernel launch per call; then its times."""
    im = torch.as_tensor(synthetic_image()[0], device=DEV)
    g = torch.Generator(device=DEV).manual_seed(4)
    segs = torch.rand((len(FAN), 584, 565, 1), device=DEV, generator=g)
    chunks = [FAN, torch.arange(1, len(FAN) + 1, dtype=torch.float32) * 21.5]
    row = None
    for name, img, sign in (("forward", im, 1.0), ("inverse", segs, -1.0)):
        table = sr.member_table([sign * c for c in chunks], 584, 565, DEV)
        for c, angles in enumerate(chunks):
            index = torch.tensor([c], device=DEV)
            out = sr.rotate_fan_table(img, table, index)
            ref = sr.rotate_fan(img, sign * angles)
            plain = sr.rotate_fan_table_plain(img, table, index)
            if not (torch.equal(out, ref) and torch.equal(out, plain)):
                raise AssertionError(f"K4 table {name} fan, chunk {c}: differs from the "
                                     f"parameter launch by {float((out - ref).abs().max())}, "
                                     f"from plain by {float((out - plain).abs().max())}")
        kernels, _ = settled(
            lambda: kernels_per_call(lambda: sr.rotate_fan_table(img, table, index)),
            lambda ks: len(ks) == 1)
        if len(kernels) != 1 or "shear_fan_table_kernel" not in kernels[0]:
            raise AssertionError(f"K4 table {name} fan: kernels {kernels}, expected one launch")
        emit({"phase": "K4-table", "fan": name, "chunks": len(chunks), "members": len(FAN),
              "limits": list(table.limits), "bit_equal_to_parameter_launch": True,
              "bit_equal_to_plain": True, "kernel_launches": 1})
        timing = {"shape": list(img.shape), "angles": len(FAN),
                  "ms": time_ms(lambda: sr.rotate_fan_table(img, table, index), 20),
                  "device_ms": device_ms(lambda: sr.rotate_fan_table(img, table, index)),
                  "parameter_launch_ms": time_ms(lambda: sr.rotate_fan(img, sign * chunks[-1]),
                                                 20),
                  "plain_ms": time_ms(lambda: sr.rotate_fan_table_plain(img, table, index), 3, 1)}
        # each input read once (the image or fan, the chunk's rows and the
        # index), each output written once
        timing["bound_ms"], timing["bound_by"] = bound_ms(
            4 * (img.numel() + len(FAN) * 584 * 565 + 6 * len(FAN)) + 8)
        timing["library_ms"] = None
        emit({"phase": "K4-table-time", "fan": name, **timing})
        if row is None:
            row = {"name": "rotate_fan_table", "route": "cuda",
                   "source": "unet_research_tpu_torch/ops/cuda/csrc/shear_rotate.cu",
                   "replaces": "unet_research_tpu/ops/pallas/shear_rotate.py:147", **timing}
        else:
            row["inverse_fan"] = timing
    row["max_abs_err"] = 0.0
    return row


# GroupNorm's epilogue at the cells' shapes: a train step's top and bottom
# sites (batch 1, K2's mask and the batch's rescale) and a rotational or MC
# chunk's top site (batch 16, no mask)
GN_SHAPES = ((1, H, W, 64), (1, H >> 4, W >> 4, 1024), (CHUNK, H, W, 64))
GN_GROUPS = 32


def check_gn() -> list:
    """GroupNorm's six epilogue launches (ops/cuda/group_norm.py) against
    their plain versions on the same card inputs at GN_SHAPES: the partial
    sums (x's, and the backward's gz's and gz*x's) and both finishing
    launches within 1e-5 of the plain float32 numbers relative to their
    largest magnitude (only the order of the sums differs; the variance
    gate exact), K3's sums as one partial too; the apply and both dx passes
    bit-equal (the same float32 operations in the same order, rounded once)
    under relu with the mask and rescale (batch 1) or without (batch 16),
    and with no activation, no mask. Each launch timed at each shape on the
    main path's variant: event ms a call, profiler device ms, its plain
    version's ms and its byte bound. Returns one row per launch."""
    rows = {fn.__name__: {"name": fn.__name__, "route": "cuda",
                          "source": "unet_research_tpu_torch/ops/cuda/csrc/group_norm.cu",
                          "replaces": "none: XLA fuses GroupNorm's epilogue in JAX",
                          "library_ms": None, "max_rel_err": 0.0}
            for fn in gnk.WRAPPERS}
    for shape in GN_SHAPES:
        n, h, w, c = shape
        hw = h * w
        g = torch.Generator(device=DEV).manual_seed(c + n)
        x = (1.3 * torch.randn(shape, device=DEV, generator=g) + 0.5).to(torch.bfloat16)
        weight = 1.0 + 0.3 * torch.randn(c, device=DEV, generator=g)
        bias = 0.2 * torch.randn(c, device=DEV, generator=g)
        gy = torch.randn(shape, device=DEV, generator=g).to(torch.bfloat16)
        if n == 1:
            mask, keep = dbk.dropblock_mask(shape, keys(c), dropblock_gamma_dependent(
                h, w, BLOCK, P_DROP), BLOCK)
            scale = (x.numel() / keep.sum().float()).reshape(())
            variants = (("relu", mask, scale), ("none", None, None))
        else:
            mask = scale = None
            variants = (("relu", None, None), ("none", None, None))
        errs = collections.defaultdict(float)

        def worst(name, err):
            if not err <= 1e-5:
                raise AssertionError(f"{name} {shape}: {err} from its plain version")
            errs[name] = max(errs[name], err)

        part = gnk.gn_stats(x)
        rpart = gnk.gn_stats_plain(x)
        worst("gn_stats", max(max_rel(part[k].sum(1), rpart[k, :, 0]) for k in range(2)))
        ab, mr = gnk.gn_stats_finish(part[0], part[1], hw, weight, bias, GN_GROUPS, 1e-5)
        rab, rmr = gnk.gn_stats_finish_plain(part[0], part[1], hw, weight, bias, GN_GROUPS,
                                             1e-5)
        k3ab, _ = gnk.gn_stats_finish(rpart[0], rpart[1], hw, weight, bias, GN_GROUPS, 1e-5)
        worst("gn_stats_finish", max(max_rel(ab, rab), max_rel(mr[:2], rmr[:2]), max_rel(k3ab, rab)))
        if not torch.equal(mr[2], rmr[2]):
            raise AssertionError(f"gn_stats_finish {shape}: the variance gate differs")
        for act, m, s in variants:
            what = f"{shape} {act}, mask {m is not None}"
            if not torch.equal(gnk.gn_apply(x, ab, m, s, act), gnk.gn_apply_plain(x, ab, m, s, act)):
                raise AssertionError(f"gn_apply {what}: not bit-equal to its plain version")
            gpart, dx = gnk.gn_grad_sums(gy, x, ab, m, s, act, dx=True)
            rgpart, rdx = gnk.gn_grad_sums_plain(gy, x, ab, m, s, act, dx=True)
            if not torch.equal(dx, rdx):
                raise AssertionError(f"gn_grad_sums dx {what}: not bit-equal to its plain version")
            worst("gn_grad_sums", max(max_rel(gpart[k].sum(1), rgpart[k, :, 0]) for k in range(2)))
            ds, dw, db = gnk.gn_grad_finish(gpart, ab, mr, weight, hw, GN_GROUPS)
            rds, rdw, rdb = gnk.gn_grad_finish_plain(gpart, ab, mr, weight, hw, GN_GROUPS)
            worst("gn_grad_finish", max(max_rel(ds, rds), max_rel(dw, rdw), max_rel(db, rdb)))
            if not torch.equal(gnk.gn_grad_dx(gy, x, ab, m, s, ds, act),
                               gnk.gn_grad_dx_plain(gy, x, ab, m, s, ds, act)):
                raise AssertionError(f"gn_grad_dx {what}: not bit-equal to its plain version")
        del rpart, rgpart, rdx, dx
        torch.cuda.synchronize()

        # the main path's variant of each launch, its bytes from its inputs
        act = "relu"
        gpart, _ = gnk.gn_grad_sums(gy, x, ab, mask, scale, act)
        ds, _, _ = gnk.gn_grad_finish(gpart, ab, mr, weight, hw, GN_GROUPS)
        m_bytes = 0 if mask is None else mask.numel()
        small = ab.numel() * 4
        calls = {
            "gn_stats": ((lambda: gnk.gn_stats(x)), (lambda: gnk.gn_stats_plain(x)),
                         x.numel() * 2 + part.numel() * 4),
            "gn_stats_finish": (
                (lambda: gnk.gn_stats_finish(part[0], part[1], hw, weight, bias, GN_GROUPS, 1e-5)),
                (lambda: gnk.gn_stats_finish_plain(part[0], part[1], hw, weight, bias, GN_GROUPS,
                                                   1e-5)),
                part.numel() * 4 + 2 * c * 4 + small + mr.numel() * 4),
            "gn_apply": ((lambda: gnk.gn_apply(x, ab, mask, scale, act)),
                         (lambda: gnk.gn_apply_plain(x, ab, mask, scale, act)),
                         2 * x.numel() * 2 + m_bytes + small),
            "gn_grad_sums": ((lambda: gnk.gn_grad_sums(gy, x, ab, mask, scale, act)),
                             (lambda: gnk.gn_grad_sums_plain(gy, x, ab, mask, scale, act)),
                             2 * x.numel() * 2 + m_bytes + small + gpart.numel() * 4),
            "gn_grad_finish": ((lambda: gnk.gn_grad_finish(gpart, ab, mr, weight, hw, GN_GROUPS)),
                               (lambda: gnk.gn_grad_finish_plain(gpart, ab, mr, weight, hw,
                                                                 GN_GROUPS)),
                               gpart.numel() * 4 + 2 * small + mr.numel() * 4 + 3 * c * 4),
            "gn_grad_dx": ((lambda: gnk.gn_grad_dx(gy, x, ab, mask, scale, ds, act)),
                           (lambda: gnk.gn_grad_dx_plain(gy, x, ab, mask, scale, ds, act)),
                           3 * x.numel() * 2 + m_bytes + 2 * small)}
        for name, (fn, plain, nbytes) in calls.items():
            timing = {"shape": list(shape), "mask": mask is not None, "act": act,
                      "ms": time_ms(fn, 10 if n == 1 else 5),
                      "device_ms": device_ms(fn, 10 if n == 1 else 5),
                      "plain_ms": time_ms(plain, 3, 1), "max_rel_err": errs[name]}
            timing["bound_ms"], timing["bound_by"] = bound_ms(nbytes)
            emit({"phase": "GN-time", "name": name, **timing})
            row = rows[name]
            row["max_rel_err"] = max(row["max_rel_err"], errs[name])
            if shape == GN_SHAPES[0]:
                row.update(timing)
            else:
                row["x".join(map(str, shape))] = timing
        del x, gy, part, ab, mr, gpart, ds, mask
    emit({"phase": "GN", "shapes": [list(s) for s in GN_SHAPES], "bit_equal":
          ["gn_apply", "gn_grad_sums dx", "gn_grad_dx"],
          "max_rel_err": {name: row["max_rel_err"] for name, row in rows.items()}})
    return list(rows.values())


def synthetic_image():
    rng = np.random.default_rng(0)
    h, w = 584, 565
    yy, xx = np.mgrid[0:h, 0:w]
    fov = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2 <= 1.0)
    im = (0.5 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
          + 0.1 * rng.standard_normal((h, w))).astype(np.float32)
    gt = (rng.random((h, w)) > 0.9).astype(np.float32)
    return (im[None, :, :, None], gt[None, :, :, None],
            fov.astype(np.float32)[None, :, :, None])


def model_for(state, **overrides):
    db = tunet.DropBlockConfig(kind=overrides.pop("kind", "dependent"), block_size=BLOCK,
                               mask_impl=overrides.pop("mask_impl", "fused"))
    cfg = tunet.canonical_config(dropblock=db, **{"dtype": torch.bfloat16,
                                                  "conv_impl": "pair", **overrides})
    model = tunet.UNet(cfg, device=DEV)
    model.load_state_dict(state)
    return model.eval()


def base_state() -> dict:
    base = tunet.UNet(tunet.canonical_config(), device=DEV,
                      generator=torch.Generator().manual_seed(0))
    return base.state_dict()


def check_outputs(mean, std, saved, ret, hw=(584, 565)) -> None:
    if not (mean.shape == std.shape == (1, *hw, 1) and saved.shape == (ret, 1, *hw, 1)):
        raise AssertionError(f"shapes {mean.shape} {std.shape} {saved.shape}")
    for t in (mean, std, saved):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite output")
    if not (0.0 <= float(mean.min()) and float(mean.max()) <= 1.0 and float(std.max()) > 0.0):
        raise AssertionError("outputs out of range or std == 0 everywhere")
    if ret and not (float(saved.min()) >= 0.0 and float(saved.max()) <= 1.0):
        raise AssertionError("saved members out of range")


def run_slice(state) -> dict:
    model = model_for(state)
    im, gt, mask = synthetic_image()
    iters, ret = 48, 4
    engine = MCDropBlockEngine(model, num_iterations=iters, return_num=ret, chunk=CHUNK,
                               device=DEV, generator=torch.Generator().manual_seed(1))
    engine.predict(im, gt, mask, P_DROP)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    forwards = 1 + (iters - ret) // CHUNK + (1 if (iters - ret) % CHUNK else 0)

    reset_counts()
    t0 = time.perf_counter()
    mean, std, saved, *_ = engine.predict(im, gt, mask, P_DROP)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    main = counts()
    expect_launches(f"MC slice ({forwards} forwards)", main,
                    {"dropblock_fused_apply": 22 * forwards, "conv3x3_pair": 3 * forwards,
                     **epilogue(k1_forwards=forwards)})
    check_outputs(mean, std, saved, ret)
    emit({"phase": "slice", "config": "canonical 31M, bf16, dependent b=7 p=0.15, pair+fused",
          "input": [584, 565], "iterations": iters, "chunk": CHUNK, "return_num": ret,
          "forwards": forwards, "seconds": seconds, "passes_per_s": iters / seconds,
          "launches": main, "mean_range": [float(mean.min()), float(mean.max())],
          "std_max": float(std.max())})

    # the mask_impl='kernel' variant of the same path runs the mask producer
    variant = model_for(state, mask_impl="kernel")
    x = torch.as_tensor(im, device=DEV).expand(CHUNK, -1, -1, -1)
    site_keys = tunet.draw_site_keys(variant.num_mask_sites(),
                                     torch.Generator().manual_seed(2)).to(DEV)
    reset_counts()
    with torch.inference_mode():
        variant(x, drop_prob=P_DROP, site_keys=site_keys)
    torch.cuda.synchronize()
    kernel_variant = counts()
    expect_launches("mask_impl='kernel'", kernel_variant,
                    {"dropblock_mask": 22, "conv3x3_pair": 3, **epilogue(forwards=1)})
    emit({"phase": "kernel-variant", "launches": kernel_variant})

    # one chunk, same site keys: kernel route vs the plain routes (GroupNorm
    # on the plain ops too)
    routes = {"kernels": model,
              "plain_bf16": model_for(state, mask_impl="elementwise", conv_impl="torch"),
              "plain_f32": model_for(state, mask_impl="elementwise", conv_impl="torch",
                                     dtype=torch.float32)}
    fov = torch.as_tensor(mask, device=DEV)
    outs = {}
    for name, m in routes.items():
        with route_epilogue(name, f"MC routes {name}"), torch.inference_mode():
            outs[name] = m(x, drop_prob=P_DROP, site_keys=site_keys) * fov
    d_kernel = float((outs["kernels"] - outs["plain_bf16"]).abs().max())
    d_bf16 = float((outs["plain_bf16"] - outs["plain_f32"]).abs().max())
    d_kernel_f32 = float((outs["kernels"] - outs["plain_f32"]).abs().max())
    emit({"phase": "routes", "max_abs_kernel_vs_plain_bf16": d_kernel,
          "max_abs_plain_bf16_vs_f32": d_bf16, "max_abs_kernel_vs_f32": d_kernel_f32,
          "mean_abs_kernel_vs_plain_bf16":
              float((outs["kernels"] - outs["plain_bf16"]).abs().mean())})
    if not d_kernel <= 2.0 * d_bf16:
        raise AssertionError(f"kernel route {d_kernel} vs plain bf16 noise {d_bf16}")
    return {"main": main, "kernel_variant": kernel_variant, "bf16_noise": d_bf16,
            "outputs": tuple(t.cpu() for t in (mean, std, saved))}


def run_rotational(state) -> dict:
    model = model_for(state, kind=None)
    im, gt, mask = synthetic_image()
    iters, ret = 359, 25
    outside, body = split_chunks(iters, ret, CHUNK)
    forwards = outside + body
    launches = {}
    for warp in ("shear", "gather"):
        engine = RotationalEngine(model, num_iterations=iters, return_num=ret, chunk=CHUNK,
                                  warp=warp, device=DEV)
        engine.predict(im, gt, mask)  # warm-up (and the capture)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        mean, std, saved, *_ = engine.predict(im, gt, mask)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        expect_launches(f"rotational {warp}", got, rotational_launches(warp, outside, body))
        check_outputs(mean, std, saved, ret)
        launches[warp] = got
        emit({"phase": "rotational-slice", "warp": warp,
              "config": "canonical 31M, bf16, DropBlock off, conv_impl='pair'",
              "input": [584, 565], "iterations": iters, "chunk": CHUNK, "return_num": ret,
              "forwards": forwards, "seconds": seconds, "passes_per_s": iters / seconds,
              "launches": got, "mean_range": [float(mean.min()), float(mean.max())],
              "std_max": float(std.max())})

    # one chunk of angles: kernel route vs the plain routes (GroupNorm on
    # the plain ops too)
    routes = {"kernels": (model, sr.rotate_fan),
              "plain_bf16": (model_for(state, kind=None, conv_impl="torch"), sr.rotate_fan_plain),
              "plain_f32": (model_for(state, kind=None, conv_impl="torch", dtype=torch.float32),
                            sr.rotate_fan_plain)}
    x = torch.as_tensor(im, device=DEV)
    fov = torch.as_tensor(mask, device=DEV)
    outs = {}
    for name, (m, warp) in routes.items():
        with route_epilogue(name, f"rotational routes {name}"), torch.inference_mode():
            outs[name] = warp(m(warp(x, FAN)).contiguous(), -FAN) * fov
    d_kernel = float((outs["kernels"] - outs["plain_bf16"]).abs().max())
    d_bf16 = float((outs["plain_bf16"] - outs["plain_f32"]).abs().max())
    emit({"phase": "rotational-routes", "angles": FAN.tolist(),
          "max_abs_kernel_vs_plain_bf16": d_kernel, "max_abs_plain_bf16_vs_f32": d_bf16,
          "max_abs_kernel_vs_f32": float((outs["kernels"] - outs["plain_f32"]).abs().max()),
          "mean_abs_kernel_vs_plain_bf16":
              float((outs["kernels"] - outs["plain_bf16"]).abs().mean())})
    if not d_kernel <= 2.0 * d_bf16:
        raise AssertionError(f"rotational kernel route {d_kernel} vs plain bf16 noise {d_bf16}")
    launches["bf16_noise"] = d_bf16
    return launches


def rotational_launches(warp: str, outside: int, body: int, captured: bool = True) -> dict:
    """The kernels of a rotational ensemble of `outside` chunks run from the
    host and `body` chunks of its program: K3 3 per forward, GroupNorm's
    epilogue at the 26 sites; under 'shear' K4 twice per chunk, by its table
    launch in the program's chunks of the captured route and by its
    parameter launch in every other chunk."""
    want = {"conv3x3_pair": 3 * (outside + body), **epilogue(forwards=outside + body)}
    if warp == "shear":
        table = body if captured else 0
        want.update(rotate_fan=2 * (outside + body - table), rotate_fan_table=2 * table)
    return want


def merged_k4(launches: dict) -> dict:
    """Launch counts with K4's two launch paths summed under rotate_fan."""
    out = dict(launches)
    out["rotate_fan"] += out.pop("rotate_fan_table")
    return out


def run_program_phase(phase: str, row: dict, engines: dict, call, want: dict, members: int,
                      body: int, noise: float) -> dict:
    """One ensemble through its device program (engines["captured"]) and
    with every chunk from the host (engines["eager"]), on the same inputs
    and generator seed: each route's launches (`want[route]`, every K3 on
    wgmma), equal in sum per kernel (the replays' credited), mean, std and
    saved within twice the plain bf16 route's distance from float32
    (`noise`), one replay's kernels equal by name and number to one eager
    chunk step's (profiler kernel events after a warm-up call, copies and
    memsets left out) and those of the wrappers equal to the counts a
    replay is credited with; then both routes' passes/s and peak
    allocation, the capture's seconds, a replayed and an eager chunk's ms
    and the idle share of the `body` replays of an ensemble (the union of
    their kernels' intervals over their wall time, from the first of up to
    three profiled windows that recorded every kernel launched, else the
    fullest, flagged: the profiler has dropped records over long windows).
    Returns the captured route's launches."""
    runs = {}
    for route, engine in engines.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call(engine)  # warm-up: on the captured route the first body chunk and the capture
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outputs = call(engine)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        expect_launches(f"{phase} {route}", got, want[route])
        runs[route] = {"launches": got, "seconds": seconds, "outputs": outputs,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    captured, eager = runs["captured"], runs["eager"]
    if merged_k4(captured["launches"]) != merged_k4(eager["launches"]):
        raise AssertionError(f"{phase}: launches {captured['launches']} (captured), "
                             f"{eager['launches']} (eager)")
    diffs = {name: float((a - b).abs().max())
             for name, a, b in zip(("mean", "std", "saved"), captured["outputs"],
                                   eager["outputs"])}
    if not max(diffs.values()) <= 2.0 * noise:
        raise AssertionError(f"{phase}: captured against eager {diffs}, gate {2.0 * noise}")

    (prog,) = engines["captured"].programs.values()
    with torch.inference_mode():
        zero = torch.zeros_like(prog.index)

    def reset():
        prog.index.copy_(zero)

    def eager_chunk():
        with torch.inference_mode():
            reset()
            prog.step()

    def replay_chunk():
        with torch.inference_mode():
            reset()
            prog.graph.replay()

    credited = {key: prog.replay_counts.get(key, 0) for key in cuda_launches.KERNELS.values()}

    def chunk_pair():
        eager_k = kernel_names(window(eager_chunk))
        replay_k = kernel_names(window(replay_chunk))
        return eager_k, replay_k, by_credit(replay_k)

    (eager_k, replay_k, replayed), _ = settled(
        chunk_pair, lambda r: r[1] and r[0] == r[1] and r[2] == credited)
    if replayed != credited:
        raise AssertionError(f"{phase}: a replay launched {replayed}, credited {credited}")
    if eager_k != replay_k or not replay_k:
        differ = {name[:160]: (replay_k[name], eager_k[name])
                  for name in set(replay_k) | set(eager_k) if replay_k[name] != eager_k[name]}
        raise AssertionError(f"{phase}: one replay launches {sum(replay_k.values())} kernels, "
                             f"one eager chunk {sum(eager_k.values())}; (replay, eager) where "
                             f"they differ: {differ}")

    def replays():
        with torch.inference_mode():
            reset()
            for _ in range(body):
                prog.graph.replay()

    # the epoch resets the index once, then replays `body` times; the reset
    # is one device-to-device copy, which kernel_events leaves out
    launched = body * sum(replay_k.values())
    # the profiler can drop kernel records over a long window (seen: 4,844
    # of 13,440 once): up to three windows, the first that recorded every
    # kernel counts, else the fullest, flagged
    traces = []

    def replays_window():
        traces.append(window(replays))
        return len(kernel_events(traces[-1]))

    settled(replays_window, lambda n: n == launched)
    trace = max(traces, key=lambda t: len(kernel_events(t)))
    recorded, wall, busy = len(kernel_events(trace)), trace.wall_s * 1e3, trace.busy_s * 1e3
    gn_ms = epilogue_device_ms(trace, body)
    replay_ms = time_ms(replays, 3, 1) / body
    eager_ms = time_ms(eager_chunk, 3)
    emit({"phase": phase, **row, "members": members, "body_chunks": body, "card": power_limit(),
          "warmup_chunks": prog.WARMUP, "capture_seconds": prog.capture_seconds,
          "replay_launches": prog.replay_counts, "kernels_per_chunk": sum(replay_k.values()),
          "replayed_chunk_ms": replay_ms, "eager_chunk_ms": eager_ms,
          "replays": {"wall_ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall,
                      "kernels_recorded": recorded, "kernels_launched": launched,
                      "complete": recorded == launched, "windows": len(traces),
                      "epilogue_device_ms_per_chunk": gn_ms},
          "passes_per_s": {route: members / r["seconds"] for route, r in runs.items()},
          "seconds": {route: r["seconds"] for route, r in runs.items()},
          "peak_gib": {route: r["peak_gib"] for route, r in runs.items()},
          "reserved_gib": {route: r["reserved_gib"] for route, r in runs.items()},
          "max_abs_captured_vs_eager": diffs, "gate": 2.0 * noise,
          "launches": {route: r["launches"] for route, r in runs.items()}})
    return captured["launches"]


def run_mc_program(state, noise: float) -> dict:
    """`mc-program`: the MC engine of run_slice's model through its device
    program and from the host (run_program_phase), 172 members: the saved
    4, 10 body chunks of 16 and a remainder of 8."""
    model = model_for(state)
    im, gt, mask = synthetic_image()
    members, ret = 172, 4
    outside, body = split_chunks(members, ret, CHUNK)
    engines = {route: MCDropBlockEngine(model, num_iterations=members, return_num=ret,
                                        chunk=CHUNK, device=DEV, program=route == "captured")
               for route in ("captured", "eager")}

    def call(engine):
        return engine.predict(im, gt, mask, P_DROP, generator=torch.Generator().manual_seed(3))[:3]

    forwards = outside + body
    want = {"dropblock_fused_apply": 22 * forwards, "conv3x3_pair": 3 * forwards,
            **epilogue(k1_forwards=forwards)}
    row = {"config": "canonical 31M, bf16, dependent b=7 p=0.15, pair+fused",
           "input": [584, 565], "chunk": CHUNK, "return_num": ret}
    return run_program_phase("mc-program", row, engines, call,
                             {"captured": want, "eager": want}, members, body, noise)


def run_rotational_program(state, noise: float) -> dict:
    """`rotational-program`: the rotational engine (359 angles, 25 saved,
    20 body chunks of 16, a remainder of 14) through its device program and
    from the host, under both warps (run_program_phase). Returns the shear
    warp's captured launches."""
    model = model_for(state, kind=None)
    im, gt, mask = synthetic_image()
    members, ret = 359, 25
    outside, body = split_chunks(members, ret, CHUNK)
    out = {}
    for warp in ("shear", "gather"):
        engines = {route: RotationalEngine(model, num_iterations=members, return_num=ret,
                                           chunk=CHUNK, warp=warp, device=DEV,
                                           program=route == "captured")
                   for route in ("captured", "eager")}
        want = {route: rotational_launches(warp, outside, body, route == "captured")
                for route in engines}
        row = {"warp": warp, "config": "canonical 31M, bf16, DropBlock off, conv_impl='pair'",
               "input": [584, 565], "chunk": CHUNK, "return_num": ret}
        out[warp] = run_program_phase("rotational-program", row, engines,
                                      lambda engine: engine.predict(im, gt, mask)[:3], want,
                                      members, body, noise)
    return out

# --- the full MC ensemble and the epoch arms ---------------------------------

FULL_MEMBERS = 1000
FULL_CALLS, FULL_CHECKED = 5, 3   # predicts on one engine; the last three each checked
ROUTE_MEMBERS = 300
EPOCH_TIME_EPOCHS = 2


def full_launches(conv: str, mask: str, members: int, chunk: int) -> dict:
    """The kernel launches of one predict with no member saved: K3 3 per
    forward under pair, K1 at the 22 sites under fused, its 4 merges in its
    merge mode (`merge:kernel`; no `merge:plain`), the wgmma kernel for
    every K3 launch, and GroupNorm's epilogue (bf16) beside K1 (`epilogue`),
    else at all 26 GroupNorm sites, each with its statistics unless K3
    brought its sums."""
    forwards = sum(split_chunks(members, 0, chunk))
    want = {}
    if conv == "pair":
        want.update({"conv3x3_pair": 3 * forwards, "path:wgmma": 3 * forwards})
    if mask == "fused":
        want["dropblock_fused_apply"] = TRAIN_SITES * forwards
        want["merge:kernel"] = U_MERGES * forwards
        want.update(epilogue(k1_forwards=forwards))
    else:
        want.update(epilogue(forwards=forwards, k3=conv == "pair"))
    return {name: n for name, n in want.items() if n}  # as launches.since gives them


def full_predicts(where: str, model, conv: str, mask: str, members: int, chunk: int,
                  resize: int = -1) -> dict:
    """FULL_CALLS predicts of one engine (no member saved, generators seeded
    0, 1, ...) on synthetic_image, counted from 0 before them: each of the
    last FULL_CHECKED launches full_launches's counts, all of them together
    FULL_CALLS times those, and the program that the first call captured is
    the one program, replayed by every later call; the statistics in range.
    Returns the launches, the skip merges by route (`merge:*` of all the
    predicts, each FULL_CALLS times full_launches's), the last call's seed,
    mean and std, the capture's seconds."""
    engine = MCDropBlockEngine(model, num_iterations=members, return_num=0, chunk=chunk,
                               resize=resize, device=DEV)
    im, gt, mask_im = synthetic_image()
    want = full_launches(conv, mask, members, chunk)
    reset_counts()
    start = cuda_launches.snapshot()
    graph, captures = None, cuda_launches.HOST["graph:captures"]
    for seed in range(FULL_CALLS):
        before = cuda_launches.snapshot()
        mean, std, *_ = engine.predict(im, gt, mask_im, P_DROP,
                                       generator=torch.Generator().manual_seed(seed))
        got = cuda_launches.launched(cuda_launches.since(before))
        if seed >= FULL_CALLS - FULL_CHECKED and got != want:
            raise AssertionError(f"{where}: predict {seed} launched {got}, expected {want}")
        (prog,) = engine.programs.values()
        graph = graph or prog.graph
        if prog.graph is None or prog.graph is not graph:
            raise AssertionError(f"{where}: predict {seed} did not replay the first capture")
    captures = cuda_launches.HOST["graph:captures"] - captures
    if captures != 1:
        raise AssertionError(f"{where}: {captures} captures in {FULL_CALLS} predicts")
    total = counts()
    expect_launches(where, total, {name: FULL_CALLS * n for name, n in want.items()
                                   if name in COUNTERS})
    merges = {k: v for k, v in cuda_launches.since(start).items() if k.startswith("merge:")}
    if merges != {k: FULL_CALLS * n for k, n in want.items() if k.startswith("merge:")}:
        raise AssertionError(f"{where}: skip merges {merges} in {FULL_CALLS} predicts, "
                             f"expected {want}")
    hw = (resize, resize) if resize > 0 else (584, 565)
    check_outputs(mean, std, torch.zeros((0, 1, *hw, 1)), 0, hw)
    return {"launches": total, "merges": merges, "launches_per_predict": want, "seed": seed,
            "mean": mean, "std": std, "capture_s": prog.capture_seconds}


def run_mc_full_phase(state, noise: float) -> dict:
    """`mc-full`: the MC ensemble of the canonical model (pair+fused) at its
    full size, 1000 members in chunks of 16 with none saved on the 584x565
    frame (full_predicts: each checked predict launching K1 1386, 252 of
    them merges in its merge mode, K3 189, the epilogue's statistics and
    finishing kernels 504 times and its apply 252, 63
    forwards: the first chunk, 61 replayed, a remainder of 8), its
    statistics within twice the plain bf16 route's distance from float32
    (`noise`) of one eager (program=False) 1000-member predict from the last
    call's seed; then the same at resize 256 (chunk 128, 8 forwards), and at
    300 members the canonical model on cuDNN with plain masks (no K1-K3
    launch) and on pair+fused. Returns the launches of the 1000-member
    predicts and, by part, the merges that took K1's merge mode
    (`merge:kernel` over each part's predicts)."""
    model = model_for(state)
    out = full_predicts("mc-full", model, "pair", "fused", FULL_MEMBERS, CHUNK)
    eager = MCDropBlockEngine(model, num_iterations=FULL_MEMBERS, return_num=0, chunk=CHUNK,
                              device=DEV, program=False)
    im, gt, mask = synthetic_image()
    mean, std, *_ = eager.predict(im, gt, mask, P_DROP,
                                  generator=torch.Generator().manual_seed(out["seed"]))
    diffs = {"mean": float((out["mean"] - mean).abs().max()),
             "std": float((out["std"] - std).abs().max())}
    if not max(diffs.values()) <= 2.0 * noise:
        raise AssertionError(f"mc-full: captured against eager {diffs}, gate {2.0 * noise}")
    row = {"phase": "mc-full", "card": power_limit(), "members": FULL_MEMBERS, "chunk": CHUNK,
           "predicts": FULL_CALLS}
    emit({**row, "part": "native", "launches_per_predict": out["launches_per_predict"],
          "capture_s": out["capture_s"], "max_abs_captured_vs_eager": diffs,
          "gate": 2.0 * noise, "launches": out["launches"], "merges": out["merges"]})
    merged = {"mc_full": out["merges"].get("merge:kernel", 0)}

    r256 = full_predicts("mc-full resize256", model, "pair", "fused", FULL_MEMBERS, 128, 256)
    emit({**row, "part": "resize256", "chunk": 128,
          "launches_per_predict": r256["launches_per_predict"], "capture_s": r256["capture_s"],
          "launches": r256["launches"], "merges": r256["merges"]})
    merged["mc_full_resize256"] = r256["merges"].get("merge:kernel", 0)
    for conv, mask in (("xla", "elementwise"), ("pair", "fused")):
        routed = model_for(state, conv_impl=cli_common.CONV_IMPLS[conv], mask_impl=mask)
        run = full_predicts(f"mc-full {conv}+{mask}", routed, conv, mask, ROUTE_MEMBERS, CHUNK)
        emit({**row, "part": f"{conv}+{mask}", "members": ROUTE_MEMBERS,
              "launches_per_predict": run["launches_per_predict"], "launches": run["launches"],
              "merges": run["merges"]})
        merged[f"mc_full_{conv}+{mask}"] = run["merges"].get("merge:kernel", 0)
    return out["launches"], merged


def run_epoch_time_phase(data: str) -> dict:
    """`epoch-time`: scripts/epoch_time_torch.py's arms (-conv_impl xla,
    then pair) on the generated augmented tree, EPOCH_TIME_EPOCHS epochs
    each (the second gives the seconds per epoch after the capture), with
    each arm's launches asserted: K2 at 40 sites per step in both, K3, its
    dx and the fold in the pair arm only. Returns each arm's launches."""
    n_train, n_val, n_test = 3 * AUG_TRAIN, 2, 2
    steps = EPOCH_TIME_EPOCHS * n_train
    out = {}
    for arm in epoch_time_torch.ARMS:
        val_forwards = EPOCH_TIME_EPOCHS * n_val + n_val + n_test
        want = {"dropblock_mask": (TRAIN_SITES + REMAT_SITES) * steps,
                **epilogue(forwards=2 * steps + val_forwards, steps=steps, k3=arm == "pair")}
        if arm == "pair":
            want.update({"conv3x3_pair": 6 * steps + 3 * (EPOCH_TIME_EPOCHS * n_val + n_val
                                                          + n_test),
                         "conv3x3_pair_dx": 3 * steps, "conv3x3_pair_fold": 3 * steps})
        reset_counts()
        row = epoch_time_torch.run_arm(arm, data, EPOCH_TIME_EPOCHS)
        got = counts()
        expect_launches(f"epoch_time {arm}", got, want)
        if not (len(row["epoch_s"]) == EPOCH_TIME_EPOCHS and np.isfinite(row["final_train_loss"])):
            raise AssertionError(f"epoch_time {arm}: {row}")
        emit({"phase": "epoch-time", "card": power_limit(), "train_images": n_train, **row})
        out[f"epoch_time_{arm}"] = got
    return out

# --- training ---------------------------------------------------------------

TRAIN_SITES = 22        # mask sites of the canonical model, one step forward
REMAT_SITES = 18        # the ConvBlock sites that remat runs again in the backward


def k3_grads(fn, x, w, cots):
    """(dx, dK) of fn(x, w, stats=True) for the cotangents (dy, ds1, ds2)."""
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    return torch.autograd.grad(fn(xr, wr, stats=True), (xr, wr), cots)


def check_k3_backward() -> tuple[dict, dict]:
    """K3's backward (the fold kernel, one dx launch, dK by cuDNN's wgrad)
    against autograd of the plain version, at the train shapes (n, 592,
    576, C_in) -> 64 for n = 1 and 2 (a train_batch 2 step's), with
    nonzero (n, 64) cotangents on the sums, in bf16 and float32; in bf16
    also the fold against its plain version and dK against the float32
    correlation; times in bf16 at n = 1. Returns the rows of K3's backward
    and of the fold."""
    row = fold_row = None
    worst = fold_worst = 0.0
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-3)):
        for cin, n in ((64, 1), (128, 1), (64, 2), (128, 2)):
            g = torch.Generator(device=DEV).manual_seed(cin + 5 + 1000 * (n - 1))
            x = torch.randn((n, H, W, cin), device=DEV, generator=g).to(dtype)
            w = conv_weights(cin, 64).to(dtype)
            cots = (torch.randn((n, H, W, 64), device=DEV, generator=g).to(dtype),
                    0.5 * torch.randn((n, 64), device=DEV, generator=g),
                    0.5 * torch.randn((n, 64), device=DEV, generator=g))
            before = pc.conv3x3_pair_dx.launches
            kdx, kdk = k3_grads(pc.conv3x3_pair, x, w, cots)
            if pc.conv3x3_pair_dx.launches != before + 1:
                raise AssertionError("K3 backward did not launch K3 once for dx")
            if dtype == torch.bfloat16 and pc.conv3x3_pair_dx.path != "wgmma":
                raise AssertionError(f"K3 dx took {pc.conv3x3_pair_dx.path} at a main-path shape")
            pdx, pdk = k3_grads(pc.conv3x3_pair_plain, x, w, cots)
            torch.cuda.synchronize()
            rel = {name: float((a.float() - b.float()).abs().max() / b.float().abs().max())
                   for name, a, b in (("dx", kdx, pdx), ("dK", kdk, pdk))}
            if max(rel.values()) > tol:
                raise AssertionError(f"K3 backward {list(x.shape)}->64 {dtype}: {rel} > {tol}")
            row_k3 = {"phase": "K3-bwd", "shape": list(x.shape), "cout": 64, "dtype": str(dtype),
                      "dx_path": pc.conv3x3_pair_dx.path, "dx_max_rel": rel["dx"],
                      "dK_max_rel": rel["dK"], "limit": tol}
            if dtype != torch.bfloat16:
                emit(row_k3)
                continue
            worst = max(worst, float((kdx.float() - pdx.float()).abs().max()))
            # the fold against its plain version; dK in bf16 is cuDNN's
            # wgrad with float32 accumulation: hold it against the float32
            # correlation of x and the same folded g
            y = pc.conv3x3_pair(x, w, stats=True)[0]
            dx_args = (cots[0], w, y, cots[1], cots[2])
            fold_args = (cots[0], y, cots[1], cots[2])
            fold = pc.conv3x3_pair_fold_plain(*fold_args)
            g = pc.conv3x3_pair_fold(*fold_args)
            g_ulps = bf16_ulps(g, fold)
            fold_worst = max(fold_worst, float((g.float() - fold.float()).abs().max()))
            if g_ulps > 1 or not torch.equal(pc.conv3x3_pair_dx(*dx_args)[1], g):
                raise AssertionError(f"K3 fold {list(x.shape)}->64: g {g_ulps} bf16 ulps from "
                                     "the plain fold")
            x_nchw, fold_nchw = x.permute(0, 3, 1, 2), fold.permute(0, 3, 1, 2)
            dk32 = torch.nn.grad.conv2d_weight(x_nchw.float(), (64, cin, 3, 3), fold_nchw.float(),
                                               padding=1).permute(2, 3, 1, 0)
            dk_rel = float((kdk.float() - dk32).abs().max() / dk32.abs().max())
            if dk_rel > 4e-3:
                raise AssertionError(f"K3 backward {list(x.shape)}->64: bf16 dK {dk_rel} from "
                                     "float32 > 4e-3")
            emit({**row_k3, "g_max_ulps": g_ulps, "dK_vs_f32_max_rel": dk_rel})
            if n != 1:
                continue
            routes = {}
            for name, fn in (("kernel", pc.conv3x3_pair), ("plain", pc.conv3x3_pair_plain)):
                xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
                outs = fn(xr, wr, stats=True)
                def backward(outs=outs, xr=xr, wr=wr):
                    return torch.autograd.grad(outs, (xr, wr), cots, retain_graph=True)
                routes[name] = (time_ms(backward, 10), device_ms(backward, 10))
            g_nchw = cots[0].permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib = time_ms(lambda: (torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, g_nchw, padding=1),
                                   torch.nn.grad.conv2d_weight(x_nchw, w_oihw.shape, g_nchw, padding=1)), 10)
            def dx_call():
                return pc.conv3x3_pair_dx(*dx_args)
            def dk_call():
                return torch.nn.grad.conv2d_weight(x_nchw, (64, cin, 3, 3), fold_nchw, padding=1)
            npix = H * W
            # reads dy, y, x and K once, writes dx and dK once; dx and dK
            # are one 3x3 conv each
            bound, by = bound_ms(2 * npix * (64 + 64 + cin + cin) + 4 * 9 * cin * 64,
                                 2 * 2.0 * 9 * cin * 64 * npix)
            timing = {"shape": [1, H, W, cin], "cout": 64, "ms": routes["kernel"][0],
                      "device_ms": routes["kernel"][1], "dx_ms": time_ms(dx_call, 20),
                      "dx_device_ms": device_ms(dx_call, 20), "dK_ms": time_ms(dk_call, 20),
                      "dK_device_ms": device_ms(dk_call, 20), "g_max_ulps": g_ulps,
                      "dK_vs_f32_max_rel": dk_rel, "plain_ms": routes["plain"][0],
                      "plain_device_ms": routes["plain"][1], "bound_ms": bound,
                      "bound_by": by, "library_ms": lib}
            emit({"phase": "K3-bwd-time", **timing})
            if cin == 64:
                row = {"name": "conv3x3_pair backward (conv3x3_pair_dx)", "route": "cuda",
                       "source": "unet_research_tpu_torch/ops/cuda/csrc/pair_conv.cu",
                       "replaces": "unet_research_tpu/ops/pallas/pair_conv.py:393", **timing}
                def fold_call():
                    return pc.conv3x3_pair_fold(*fold_args)
                fold_row = {"name": "conv3x3_pair_fold", "route": "cuda",
                            "source": "unet_research_tpu_torch/ops/cuda/csrc/pair_conv.cu",
                            "replaces": "unet_research_tpu/ops/pallas/pair_conv.py:399",
                            "shape": list(g.shape),
                            "ms": time_ms(fold_call, 20), "device_ms": device_ms(fold_call, 20),
                            "plain_ms": time_ms(lambda: pc.conv3x3_pair_fold_plain(*fold_args), 20),
                            "library_ms": None}
                # reads dy and y, writes g, each once
                fold_row["bound_ms"], fold_row["bound_by"] = bound_ms(3 * g.numel() * 2)
                emit({"phase": "fold-time", **fold_row})
            else:
                row["128_to_64"] = timing
    row["max_abs_err"], fold_row["max_abs_err"] = worst, fold_worst
    return row, fold_row


def check_k3_valid() -> dict:
    """conv3x3_pair_valid (K3 + interior crop) against F.conv2d VALID."""
    x, w = activation(1, 64, seed=9), conv_weights(64, 64)
    y = pc.conv3x3_pair_valid(x, w)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    rel = float((y.float() - ref.float()).abs().max() / ref.float().abs().max())
    if y.shape != ref.shape or rel > 1e-2 or pc.conv3x3_pair.path != "wgmma":
        raise AssertionError(f"K3 valid: shape {tuple(y.shape)}, rel {rel}, {pc.conv3x3_pair.path}")
    w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out = {"phase": "K3-valid", "shape": list(x.shape), "cout": 64, "y_max_rel": rel,
           "ms": time_ms(lambda: pc.conv3x3_pair_valid(x, w), 20),
           "device_ms": device_ms(lambda: pc.conv3x3_pair_valid(x, w), 20),
           "plain_ms": time_ms(lambda: torch.nn.functional.conv2d(
               x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)), 20),
           "library_ms": time_ms(lambda: torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w_lib), 20),
           "library_device_ms": device_ms(
               lambda: torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w_lib), 20)}
    out["bound_ms"], out["bound_by"] = bound_ms(2 * (H * W * 64 + (H - 2) * (W - 2) * 64) + 2 * 9 * 64 * 64,
                                                2.0 * 9 * 64 * 64 * (H - 2) * (W - 2))
    emit(out)
    return out


def train_dataset(n: int, seed: int) -> ArrayDataset:
    """n seeded variants of the synthetic 584x565 image, uint8 NHWC."""
    im, gt, fov = synthetic_image()
    rng = np.random.default_rng(seed)
    ims = np.clip(im + 0.05 * rng.standard_normal((n,) + im.shape[1:]), 0, 1)
    gts = np.repeat(gt, n, axis=0)
    fovs = np.repeat(fov, n, axis=0)
    return ArrayDataset(*((a * 255).round().astype(np.uint8) for a in (ims, gts, fovs)))


def train_model(state, nr_steps: int = 8, **overrides):
    db = tunet.DropBlockConfig(kind="dependent", block_size=BLOCK, use_scheduler=True,
                               start_drop_prob=0.0, max_drop_prob=P_DROP, nr_steps=nr_steps,
                               mask_impl=overrides.pop("mask_impl", "kernel"))
    cfg = tunet.canonical_config(dropblock=db, **{"dtype": torch.bfloat16, "remat": True,
                                                  "conv_impl": "pair", **overrides})
    model = tunet.UNet(cfg, device=DEV)
    model.load_state_dict(state)
    return model


def run_train_routes(state) -> None:
    """One train step from the same weights, batch and site keys through the
    kernel route and the two plain routes (GroupNorm on the plain ops)."""
    ds = train_dataset(1, seed=3)
    im, gt, fov = (torch.as_tensor(a, device=DEV) for a in ds[np.arange(1)])
    keys = tunet.draw_site_keys(TRAIN_SITES, torch.Generator().manual_seed(4)).to(DEV)
    routes = {"kernels": {},
              "plain_bf16": {"conv_impl": "torch", "mask_impl": "elementwise"},
              "plain_f32": {"conv_impl": "torch", "mask_impl": "elementwise",
                            "dtype": torch.float32}}
    out = {}
    for name, kw in routes.items():
        model = train_model(state, **kw)
        with route_epilogue(name, f"train routes {name}"):
            loss = masked_rescaled_bce(model(im, drop_prob=P_DROP, site_keys=keys, train=True),
                                       gt, fov)
            loss.backward()
        grad = torch.cat([p.grad.reshape(-1).float() for p in model.parameters()])
        out[name] = (float(loss.detach()), grad)
        del model
    def gdist(a, b):
        return float((out[a][1] - out[b][1]).norm() / out[b][1].norm())
    d = {"loss_kernel_vs_plain_bf16": abs(out["kernels"][0] - out["plain_bf16"][0]),
         "loss_plain_bf16_vs_f32": abs(out["plain_bf16"][0] - out["plain_f32"][0]),
         "loss_kernel_vs_f32": abs(out["kernels"][0] - out["plain_f32"][0]),
         "grad_rel_l2_kernel_vs_plain_bf16": gdist("kernels", "plain_bf16"),
         "grad_rel_l2_plain_bf16_vs_f32": gdist("plain_bf16", "plain_f32"),
         "grad_rel_l2_kernel_vs_f32": gdist("kernels", "plain_f32")}
    emit({"phase": "train-routes", "losses": {k: v[0] for k, v in out.items()}, **d})
    if not (d["loss_kernel_vs_plain_bf16"] <= 2.0 * d["loss_plain_bf16_vs_f32"]
            and d["grad_rel_l2_kernel_vs_plain_bf16"] <= 2.0 * d["grad_rel_l2_plain_bf16_vs_f32"]):
        raise AssertionError(f"train routes: kernel route beyond twice the bf16 noise: {d}")


def run_train_slice(state) -> dict:
    """Trainer.fit of the canonical model on the card, its launch counts,
    the time of a train step, and one lr_find sweep. Returns the fit's
    launch counts and its number of steps."""
    train_ds, val_ds = train_dataset(8, seed=1), train_dataset(2, seed=2)
    model = train_model(state)
    cfg = TrainerConfig(max_epochs=3, lr=1e-3, momentum=0.99, clip_norm=0.5, auto_lr_find=False,
                        seed=0, verbose=False)
    trainer = Trainer(model, POLICIES["none"], cfg, device=DEV)
    out_dir = os.path.join(ROOT, "_runs", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    steps, val_forwards = 3 * len(train_ds), 3 * len(val_ds)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fit_state, history, keeper = trainer.fit(train_ds, val_ds, os.path.join(out_dir, "model_info"),
                                             params=state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    expect_launches("train fit", got, train_want(steps, val_forwards))
    losses = history["train_loss_epoch"] + history["val_loss_epoch"]
    if not (len(history["val_loss_epoch"]) == 3 and all(np.isfinite(losses))):
        raise AssertionError(f"train history {history}")
    files = os.listdir(os.path.join(out_dir, "model_info"))
    if len(files) != 1 or fit_state.step != steps:
        raise AssertionError(f"kept files {files}, step {fit_state.step}")

    # the time of one step alone (the fit above includes validation and saves)
    data = tuple(torch.as_tensor(a, device=DEV)
                 for a in (train_ds.images, train_ds.targets, train_ds.masks))
    step_ms = time_ms(lambda: trainer.train_step_indexed(fit_state, data, 0, 1e-3), 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": "train-slice", "config": "canonical 31M, bf16, remat, dependent b=7 ramp "
          "0->0.15 over 8 steps, pair + kernel masks, SGD 1e-3 momentum 0.99 clip 0.5",
          "input": [584, 565], "train_images": len(train_ds), "val_images": len(val_ds),
          "epochs": 3, "steps": steps, "seconds": seconds, "steps_per_s": steps / seconds,
          "train_step_ms": step_ms, "peak_gib": peak, "launches": got, "history": history,
          "kept": files})

    t0 = time.perf_counter()
    suggestion = lr_find(trainer, state, train_ds, None, 0, num_training=20)
    emit({"phase": "lr-find", "num_training": 20, "suggestion": suggestion,
          "seconds": time.perf_counter() - t0})
    shutil.rmtree(out_dir, ignore_errors=True)
    return got, steps


def window(fn) -> tracing.Trace:
    """One marked profiler window of one call of fn (benchmark/tracing.py):
    the device operations that start after a marker kernel, none where the
    window lost its marker. fn runs once more before the marker, inside the
    window (from the snapshot the window reads first): a window can lose its
    first records while the tracer starts (seen: the marker of every window
    of a phase), and those are then that call's, which do not count."""
    warm = [fn]

    def snapshot():
        if warm:
            warm.pop()()
            torch.cuda.synchronize()
        return cuda_launches.snapshot()

    return tracing.profile(fn, snapshot, tries=1)[0]


def settled(measure, agree, tries: int = 3):
    """measure() up to `tries` times, until agree(result) holds; returns the
    last result and the number of windows it took. The profiler loses kernel
    records at random (seen: one conv3x3_wgmma_kernel and one
    conv3x3_fold_kernel record of an 8-replay epoch; 4 of 320 K2 records of
    a window; every record of a short window, its marker included), and
    never adds one, while the kernels measured are the same in every window
    (a graph replay, or the same eager step), so a count that disagrees is
    measured again and one that disagrees in every window stands and fails
    at the caller."""
    for n in range(1, tries + 1):
        result = measure()
        if agree(result):
            break
    return result, n


def kernel_events(trace: tracing.Trace) -> list:
    """A window's kernels, copies and memsets left out: eagerly they are copy
    and memset operations, in a graph replay the graph's own memcpy and
    memset kernels."""
    return [op for op in trace.ops if not op[0].lower().startswith(("memcpy", "memset"))]


def kernel_names(trace: tracing.Trace) -> collections.Counter:
    """A window's kernels (kernel_events) by name and number."""
    return collections.Counter(name for name, _, _ in kernel_events(trace))


def epilogue_device_ms(trace: tracing.Trace, per: int) -> dict:
    """Device ms of GroupNorm's epilogue kernels in a window, by kernel and
    in all, per one of `per` replays."""
    ms = {fn.__name__: trace.recorded(f"{fn.__name__}_kernel")[1] * 1e3 / per
          for fn in gnk.WRAPPERS}
    return {**ms, "all": sum(ms.values())}


def by_credit(names: collections.Counter) -> dict:
    """Kernel counts by name (kernel_names) summed into the launch counts
    that name them (ops/cuda/launches.py::KERNELS)."""
    return {key: sum(n for name, n in names.items() if part in name)
            for part, key in cuda_launches.KERNELS.items()}


def run_train_scan(state) -> None:
    """Trainer.fit of the canonical model with scanned epochs (a CUDA graph of
    the step replayed over each epoch) and stepping, from the same weights
    and seed, over a ramp that spans the first epoch boundary: losses and
    parameters within JAX's scan-against-step tolerance, equal launches,
    one replay's kernels those of one eager step, every K3 launch on wgmma,
    an epoch of replays launching the kernels it is credited with (each
    count the most that up to five profiled windows recorded); then the
    replayed and the eager step's times and a scanned epoch's idle share."""
    train_ds, val_ds = train_dataset(8, seed=1), train_dataset(2, seed=2)
    steps = 3 * len(train_ds)
    out_root = os.path.join(ROOT, "_runs", "chip_smoke_scan")
    shutil.rmtree(out_root, ignore_errors=True)
    fits = {}
    for scan in (True, False):
        model = train_model(state, nr_steps=12)
        start = flat_params(model)
        cfg = TrainerConfig(max_epochs=3, lr=1e-3, momentum=0.99, clip_norm=0.5,
                            auto_lr_find=False, seed=0, verbose=False, scan_epochs=scan)
        # the stepped fit takes every step from the host (program=False)
        trainer = Trainer(model, POLICIES["none"], cfg, device=DEV, program=scan)
        programs = []
        scan_fn = trainer.train_epoch_scan

        def spy(*args, trainer=trainer, scan_fn=scan_fn, programs=programs):
            losses = scan_fn(*args)
            programs.append(trainer._program)
            return losses

        trainer.train_epoch_scan = spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        fit_state, history, _ = trainer.fit(train_ds, val_ds,
                                            os.path.join(out_root, f"scan_{scan}"), params=state)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        assert_wgmma(f"train-scan fit, scan_epochs={scan}")
        if fit_state.step != steps or len(programs) != (3 if scan else 0):
            raise AssertionError(f"scan_epochs={scan}: step {fit_state.step}, "
                                 f"{len(programs)} scanned epochs")
        fits[scan] = {"history": history, "params": flat_params(model), "start": start,
                      "launches": got,
                      "seconds": seconds, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "program": programs[0] if programs else None, "trainer": trainer,
                      "state": fit_state}
    scanned, stepped = fits[True], fits[False]
    want = train_want(steps, 3 * len(val_ds))
    if not scanned["launches"] == stepped["launches"] == want:
        raise AssertionError(f"train-scan launches {scanned['launches']} (scanned), "
                             f"{stepped['launches']} (stepped), expected {want}")
    a = np.array(scanned["history"]["train_loss_epoch"] + scanned["history"]["val_loss_epoch"])
    b = np.array(stepped["history"]["train_loss_epoch"] + stepped["history"]["val_loss_epoch"])
    loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
    param_rel = rel_l2(scanned["params"], stepped["params"])
    # how far the fit moved the weights: the parameters' bound must be well
    # inside it, or a scanned fit that never updated them would pass
    movement = rel_l2(stepped["params"], stepped["start"])
    if not (np.isfinite(a).all() and loss_rel <= 2e-3 and param_rel <= 1e-4
            and param_rel <= 0.1 * movement):
        raise AssertionError(f"train-scan: scanned against stepped losses {a} / {b} "
                             f"(max rel {loss_rel}), parameters' relative L2 {param_rel}, "
                             f"the fit's own movement {movement}")

    # one replay against one eager step of the same program, by kernel; the
    # index is set to step 0 first, by a fill kernel on both sides
    prog = scanned["program"]

    def eager_step():
        prog.index.zero_()
        prog.step()

    def replay_step():
        prog.index.zero_()
        prog.graphs[(-1, 1)].replay()

    (eager, replay), _ = settled(lambda: (kernel_names(window(eager_step)),
                                          kernel_names(window(replay_step))),
                                 lambda r: r[1] and r[0] == r[1])
    if eager != replay or not replay:
        differ = {name[:160]: (replay[name], eager[name]) for name in set(replay) | set(eager)
                  if replay[name] != eager[name]}
        raise AssertionError(f"one replay launches {sum(replay.values())} kernels, one eager "
                             f"step {sum(eager.values())}; (replay, eager) where they "
                             f"differ: {differ}")

    # an epoch of replays under the profiler: the kernels it ran against K
    # times the counts a replay is credited with, and its idle share, from
    # the union of the operations' intervals (the summed event times can
    # exceed the wall time) over the wall time of the traced call
    k = len(train_ds)

    def epoch_of_replays():
        prog.index.zero_()
        for _ in range(k):
            prog.graphs[(-1, 1)].replay()

    credited = {key: k * prog.replay_counts[(-1, 1)].get(key, 0)
                for key in cuda_launches.KERNELS.values()}

    # each kernel's count is the most that any of up to five windows
    # recorded: a lost record only lowers a window's count (see `settled`),
    # and records are lost in most windows of an epoch (seen: three windows
    # for one complete one), so one window that recorded all of a kernel
    # proves its count; the idle share is read from the fullest window
    seen = []

    def epoch_window():
        trace = window(epoch_of_replays)
        replayed = by_credit(kernel_names(trace))
        if any(replayed[key] > credited[key] for key in credited):
            raise AssertionError(f"an epoch of {k} replays launched {replayed}, "
                                 f"more than credited {credited}")
        seen.append((trace, replayed))
        return {key: max(w[1][key] for w in seen) for key in credited}

    replayed, windows = settled(epoch_window, lambda r: r == credited, tries=5)
    epoch_trace = max((w[0] for w in seen), key=lambda t: len(kernel_events(t)))
    wall_ms, epoch_busy_ms = epoch_trace.wall_s * 1e3, epoch_trace.busy_s * 1e3
    if replayed != credited or not replayed["dropblock_mask"]:
        raise AssertionError(f"an epoch of {k} replays launched {replayed} (the most of "
                             f"{windows} profiled windows), credited {credited}")

    # times: K replays (an epoch) and eager steps, in this call
    replay_ms = time_ms(epoch_of_replays, 3, 1) / k
    eager_ms = time_ms(eager_step, 5)
    emit({"phase": "train-scan", "config": "canonical 31M, bf16, remat, dependent b=7 ramp "
          "0->0.15 over 12 steps, pair + kernel masks, SGD 1e-3 momentum 0.99 clip 0.5",
          "input": [584, 565], "train_images": len(train_ds), "epochs": 3, "steps": steps,
          "card": power_limit(),
          "warmup_steps": prog.WARMUP, "capture_seconds": prog.capture_seconds[(-1, 1)],
          "replay_launches": prog.replay_counts[(-1, 1)],
          "replayed_step_ms": replay_ms, "eager_step_ms": eager_ms,
          "kernels_per_step": sum(replay.values()),
          "epoch_of_replays": {"wall_ms": wall_ms, "busy_ms": epoch_busy_ms,
                               "idle_share": 1.0 - epoch_busy_ms / wall_ms,
                               "epilogue_device_ms_per_step": epilogue_device_ms(epoch_trace, k),
                               "kernels_counted": replayed, "windows": windows,
                               "counted_per_window": [w[1] for w in seen]},
          "steps_per_s": {"scanned": steps / scanned["seconds"],
                          "stepped": steps / stepped["seconds"]},
          "fit_seconds": {"scanned": scanned["seconds"], "stepped": stepped["seconds"]},
          "peak_gib": {"scanned": scanned["peak_gib"], "stepped": stepped["peak_gib"]},
          "loss_max_rel": loss_rel, "param_rel_l2": param_rel, "param_movement": movement,
          "history": {"scanned": scanned["history"], "stepped": stepped["history"]},
          "launches": scanned["launches"]})
    fits.clear()
    del prog, scanned, stepped
    shutil.rmtree(out_root, ignore_errors=True)


STEP_PROGRAM_SWEEP = 100     # lr_find's steps, its default
STEP_PROGRAM_EPOCHS = 2
PLAN_SIZES = (-1, 256, 128)


@contextlib.contextmanager
def step_programs():
    """While active, collect every step program the trainer makes
    (train/loop.py::_StepProgram), to read its tables, graphs and capture
    seconds after the run; drop them before the next capture."""
    made = []
    init = tloop._StepProgram.__init__

    def record(self, *args):
        init(self, *args)
        made.append(self)

    tloop._StepProgram.__init__ = record
    try:
        yield made
    finally:
        tloop._StepProgram.__init__ = init


def smoothed_losses(losses, beta: float = 0.98) -> np.ndarray:
    """The curve that lr_find keeps from its steps' losses: their
    bias-corrected EWMA up to the step that stops the sweep (a non-finite
    loss, or a smoothed loss above 4x the best), which it leaves out."""
    out, avg = [], 0.0
    for loss in map(float, losses):
        if not np.isfinite(loss):
            break
        avg = beta * avg + (1 - beta) * loss
        smoothed = avg / (1 - beta ** (len(out) + 1))
        if out and smoothed > 4 * min(out):
            break
        out.append(smoothed)
    return np.array(out)


def train_want(steps: int, val_forwards: int) -> dict:
    """Each kernel's launches in `steps` train steps of the canonical model
    (kernel masks, pair convs, remat) and `val_forwards` validation forwards."""
    return {**{name: 0 for name in COUNTERS},
            "dropblock_mask": (TRAIN_SITES + REMAT_SITES) * steps,
            "conv3x3_pair": 6 * steps + 3 * val_forwards, "conv3x3_pair_dx": 3 * steps,
            "conv3x3_pair_fold": 3 * steps,
            **epilogue(forwards=2 * steps + val_forwards, steps=steps)}


def run_step_program_lr_find(state, train_ds) -> dict:
    """lr_find's 100-step sweep through its step program (one CUDA graph of
    the step, the learning rate read from a table on the card) against
    every step from the host (program=False), from one set of weights and
    one seed: the same number of steps, the smoothed losses within 2e-3
    relative, the suggestion within one step of the sweep's grid, equal
    launches, and both routes' seconds."""
    lrs = 1e-8 * (1.0 / 1e-8) ** (np.arange(STEP_PROGRAM_SWEEP) / (STEP_PROGRAM_SWEEP - 1))
    routes = {}
    for program in (False, True):
        model = train_model(state, nr_steps=STEP_PROGRAM_SWEEP // 2)
        cfg = TrainerConfig(lr=1e-3, momentum=0.99, clip_norm=0.5, seed=0, verbose=False)
        trainer = Trainer(model, POLICIES["none"], cfg, device=DEV, program=program)
        host_losses = []
        step_fn = trainer.train_step_indexed

        def spy(*args, step_fn=step_fn, host_losses=host_losses, **kwargs):
            loss = step_fn(*args, **kwargs)
            host_losses.append(loss)
            return loss

        trainer.train_step_indexed = spy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with step_programs() as made:
            suggestion = lr_find(trainer, state, train_ds, None, 0,
                                 num_training=STEP_PROGRAM_SWEEP)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        assert_wgmma(f"lr_find, program={program}")
        if program:
            prog, = made
            ran = int(prog.index)
            raw = prog.losses[:ran].cpu().numpy()
            # the wrapper is called by the eager warm-up steps and the capture
            extra = {"capture_seconds": prog.capture_seconds[(-1, 1)],
                     "eager_steps": prog.warm[(-1, 1)], "graphs": sorted(prog.graphs),
                     "host_steps": len(host_losses)}
            del prog
        else:
            ran = len(host_losses)
            raw = torch.stack(host_losses).cpu().numpy()
            extra = {}
        made.clear()
        del made, trainer, model, host_losses
        routes[program] = {"suggestion": suggestion, "steps": ran, "seconds": seconds,
                           "launches": got, "smoothed": smoothed_losses(raw),
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, **extra}
    captured, eager = routes[True], routes[False]
    grid = [int(np.argmin(np.abs(np.log(lrs) - np.log(r["suggestion"]))))
            for r in (captured, eager)]
    n = min(len(captured["smoothed"]), len(eager["smoothed"]))
    smooth_rel = float(np.max(np.abs(captured["smoothed"][:n] - eager["smoothed"][:n])
                              / np.abs(eager["smoothed"][:n])))
    out = {"phase": "train-step-program", "part": "lr_find", "card": power_limit(),
           "config": "canonical 31M, bf16, remat, dependent b=7 ramp 0->0.15 over 50 steps, "
                     "pair + kernel masks, momentum 0.99 clip 0.5, lr 1e-8 -> 1 over 100 steps",
           "input": [584, 565], "train_images": len(train_ds),
           "steps": {"captured": captured["steps"], "eager": eager["steps"]},
           "seconds": {"captured": captured["seconds"], "eager": eager["seconds"]},
           "capture_seconds": captured["capture_seconds"],
           "eager_steps_before_capture": captured["eager_steps"],
           "host_steps_of_the_captured_route": captured["host_steps"],
           "suggestion": {"captured": captured["suggestion"], "eager": eager["suggestion"]},
           "grid_index": grid, "smoothed_max_rel": smooth_rel,
           "smoothed_points": [len(captured["smoothed"]), len(eager["smoothed"])],
           "peak_gib": {"captured": captured["peak_gib"], "eager": eager["peak_gib"]},
           "launches": captured["launches"]}
    emit(out)
    if not (captured["steps"] == eager["steps"] and captured["graphs"] == [(-1, 1)]
            and len(captured["smoothed"]) == len(eager["smoothed"])
            and captured["host_steps"] == tloop._StepProgram.WARMUP + 1
            and np.isfinite(captured["smoothed"]).all() and smooth_rel <= 2e-3
            and abs(grid[0] - grid[1]) <= 1
            and captured["launches"] == eager["launches"] == train_want(eager["steps"], 0)):
        raise AssertionError(f"train-step-program lr_find: {out}")
    return captured["launches"]


def run_step_program_fit(state) -> dict:
    """A uni fit under a size plan of -1, 256 and 128 (2 epochs of
    3 x AUG_TRAIN items, the mf-cli phase's shape) through the step
    programs (one CUDA graph per size) against every step from the host
    (program=False), from one set of weights and one seed: the train-scan
    phase's tolerances, equal launches, one capture per size, one replay's
    kernels those of one eager step at each size, and each size's replayed
    and eager step ms."""
    n_train = 3 * AUG_TRAIN
    train_ds, val_ds = train_dataset(n_train, seed=5), train_dataset(2, seed=6)
    plan = make_size_plan("uni", 3, AUG_TRAIN, np.random.default_rng(0))
    steps = STEP_PROGRAM_EPOCHS * n_train
    out_root = os.path.join(ROOT, "_runs", "chip_smoke_step_program")
    shutil.rmtree(out_root, ignore_errors=True)
    # one eager step at each size first, so that neither route pays the
    # one-time work of a new size (cuDNN's plans, the allocator's blocks)
    warm = Trainer(train_model(state), POLICIES["uni"], TrainerConfig(seed=0, verbose=False),
                   device=DEV)
    warm_state = warm.create_state(None, 1e-3)
    data = tuple(torch.as_tensor(a, device=DEV)
                 for a in (train_ds.images, train_ds.targets, train_ds.masks))
    for size in PLAN_SIZES:
        warm.train_step_indexed(warm_state, data, 0, 1e-3, size)
    torch.cuda.synchronize()
    del warm, warm_state, data
    fits = {}
    for program in (False, True):
        model = train_model(state, nr_steps=steps // 2)
        start = flat_params(model)
        cfg = TrainerConfig(max_epochs=STEP_PROGRAM_EPOCHS, lr=1e-3, momentum=0.99,
                            clip_norm=0.5, auto_lr_find=False, seed=0, verbose=False)
        trainer = Trainer(model, POLICIES["uni"], cfg, device=DEV, program=program)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with step_programs() as made:
            fit_state, history, _ = trainer.fit(train_ds, val_ds,
                                                os.path.join(out_root, f"program_{program}"),
                                                size_plan=plan, params=state)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counts()
        assert_wgmma(f"step-program fit, program={program}")
        fits[program] = {"history": history, "params": flat_params(model), "start": start,
                         "launches": got, "seconds": seconds, "step": fit_state.step,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "program": made[0] if made else None, "made": len(made)}
    captured, eager = fits[True], fits[False]
    prog = captured["program"]
    a = np.array(captured["history"]["train_loss_epoch"] + captured["history"]["val_loss_epoch"])
    b = np.array(eager["history"]["train_loss_epoch"] + eager["history"]["val_loss_epoch"])
    loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
    param_rel = rel_l2(captured["params"], eager["params"])
    movement = rel_l2(eager["params"], eager["start"])

    # by size: one replay's kernels against one eager step's, and their ms
    by_size = {}
    for size in PLAN_SIZES:
        def eager_step(size=size):
            prog.index.zero_()
            prog.step(size)

        def replay_step(size=size):
            prog.index.zero_()
            prog.graphs[(size, 1)].replay()

        (e_names, r_names), _ = settled(
            lambda: (kernel_names(window(eager_step)), kernel_names(window(replay_step))),
            lambda r: r[1] and r[0] == r[1])
        differ = {name[:160]: (r_names[name], e_names[name])
                  for name in set(r_names) | set(e_names) if r_names[name] != e_names[name]}
        by_size[str(size)] = {"replayed_step_ms": time_ms(replay_step, 10, 2),
                              "eager_step_ms": time_ms(eager_step, 5),
                              "capture_seconds": prog.capture_seconds[(size, 1)],
                              "kernels_per_step": sum(r_names.values()),
                              "replay_launches": prog.replay_counts[(size, 1)],
                              "kernels_differ": differ}
    out = {"phase": "train-step-program", "part": "uni-fit", "card": power_limit(),
           "config": "canonical 31M, bf16, remat, dependent b=7 ramp 0->0.15 over 24 steps, "
                     "pair + kernel masks, SGD 1e-3 momentum 0.99 clip 0.5, uni size plan",
           "input": [584, 565], "train_images": n_train, "val_images": len(val_ds),
           "epochs": STEP_PROGRAM_EPOCHS, "steps": steps,
           "size_plan_counts": {str(s): int((plan == s).sum()) for s in PLAN_SIZES},
           "by_size": by_size,
           "fit_seconds": {"captured": captured["seconds"], "eager": eager["seconds"]},
           "steps_per_s": {"captured": steps / captured["seconds"],
                           "eager": steps / eager["seconds"]},
           "peak_gib": {"captured": captured["peak_gib"], "eager": eager["peak_gib"]},
           "loss_max_rel": loss_rel, "param_rel_l2": param_rel, "param_movement": movement,
           "history": {"captured": captured["history"], "eager": eager["history"]},
           "launches": captured["launches"]}
    emit(out)
    want = train_want(steps, STEP_PROGRAM_EPOCHS * len(val_ds))
    if not (captured["made"] == 1 and eager["made"] == 0
            and sorted(prog.graphs) == [(-1, 1), (128, 1), (256, 1)]
            and all(prog.warm[(s, 1)] == prog.WARMUP for s in PLAN_SIZES)
            and captured["step"] == eager["step"] == steps
            and captured["launches"] == eager["launches"] == want
            and np.isfinite(a).all() and loss_rel <= 2e-3 and param_rel <= 1e-4
            and param_rel <= 0.1 * movement
            and not any(row["kernels_differ"] or not row["kernels_per_step"]
                        for row in by_size.values())):
        raise AssertionError(f"train-step-program uni fit: {out}")
    fits.clear()
    del prog, captured, eager
    shutil.rmtree(out_root, ignore_errors=True)
    return want  # both routes' launches, asserted equal to it


def run_train_step_program(state) -> dict:
    """The stepped paths through the trainer's step programs on the card:
    lr_find, then a fit under a size plan. Returns each one's launches."""
    lr_find_launches = run_step_program_lr_find(state, train_dataset(8, seed=1))
    return {"train_step_program_lr_find": lr_find_launches,
            "train_step_program_uni_fit": run_step_program_fit(state)}


# --- eval-program: the forward programs and batched steps ------------------

EVAL_IMAGES = 8
PREDICT_AT_SIZES = ((128, 128), (256, 256), (584, 565))
# (program, model overrides) by route, in the order they run: the eager
# route, the captured one, and the plain routes whose distance bounds the
# first two's. A route's seconds are one run's, the first-use costs of its
# shapes on the eager route's; run_eval_one_shot times the two routes in
# turn
EVAL_ROUTES = {"eager": (False, {}), "captured": (True, {}),
               "plain_bf16": (False, {"conv_impl": "torch", "mask_impl": "elementwise"}),
               "plain_f32": (False, {"conv_impl": "torch", "mask_impl": "elementwise",
                                     "dtype": torch.float32})}


@contextlib.contextmanager
def forward_programs():
    """While active, collect every forward program made that captures
    (train/loop.py::ForwardProgram), to read its graphs, buffers and
    capture seconds after the run."""
    made = []
    init = tloop.ForwardProgram.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if self.captures:
            made.append(self)

    tloop.ForwardProgram.__init__ = record
    try:
        yield made
    finally:
        tloop.ForwardProgram.__init__ = init


def added(*runs) -> dict:
    """The summed launch counts of runs (each as counts() gives them)."""
    return {name: sum(run[name] for run in runs) for name in COUNTERS}


def output_dists(preds, others) -> list:
    """The largest |a - b| over the images of each of predict's four
    outputs, between two routes' (seg, im, gt, mask) lists."""
    return [max(float(np.max(np.abs(a[j].astype(np.float64) - b[j])))
                for a, b in zip(preds, others)) for j in range(4)]


def forward_times(prog, role: str, eager) -> dict:
    """By input shape: one replay of the (role, shape) graph and one eager
    call of `eager` on the same buffers, ms on the card's clock, and the
    capture's seconds."""
    out = {}
    for (r, shapes), graph in prog.graphs.items():
        if r != role:
            continue
        bufs = prog.buffers[shapes]

        def eager_call(bufs=bufs):
            with torch.no_grad():
                eager(*bufs)

        out["x".join(map(str, shapes[0]))] = {
            "replayed_ms": time_ms(graph.replay, 10), "eager_ms": time_ms(eager_call, 5),
            "capture_seconds": prog.capture_seconds[(r, shapes)]}
    return out


def run_eval_trainer_forwards(state) -> dict:
    """(a) Trainer.validate and (b) Trainer.predict on EVAL_IMAGES synthetic
    584x565 images under `none` and `lft -new_size 256`, through the
    forward program (one warm-up, one capture, replays) against
    program=False: the loss and each of predict's four outputs within twice
    the plain bf16 route's distance from plain float32, equal launches (3
    K3 per forward). Returns the captured route's launches."""
    ds = train_dataset(EVAL_IMAGES, seed=7)
    policies = {"none": POLICIES["none"], "lft256": lf_policy("lft", 256)}
    captured_launches, reference = [], {}
    for pname, policy in policies.items():
        res = {}
        for route, (program, overrides) in EVAL_ROUTES.items():
            model = train_model(state, **overrides)
            trainer = Trainer(model, policy, TrainerConfig(verbose=False), device=DEV,
                              program=program)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with route_epilogue(route, f"eval-program {pname} {route}"):
                t0 = time.perf_counter()
                val = trainer.validate(None, ds)
                t1 = time.perf_counter()
                preds = [p[1:] for p in trainer.predict(None, ds)]
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            got = counts()
            if route in ("captured", "eager"):
                assert_wgmma(f"eval-program {pname} {route}")
            res[route] = {"val": val, "preds": preds, "launches": got,
                          "validate_seconds": t1 - t0, "predict_seconds": t2 - t1,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if route == "captured":
                prog = trainer._forward
                res[route]["times"] = {
                    "val": forward_times(prog, "val", trainer.eval_step),
                    "predict": forward_times(
                        prog, "predict",
                        lambda *b, model=model, policy=policy: policy.predict_io(model, *b))}
                res[route]["graphs"] = sorted(role for role, _ in prog.graphs)
                res[route]["warm"] = sorted(prog.warm.values())
                del prog
            del trainer, model
        cap, eag, bf, f32 = (res[k] for k in ("captured", "eager", "plain_bf16", "plain_f32"))
        val_noise = abs(bf["val"] - f32["val"])
        out_names = ("seg", "im", "gt", "mask")
        pred_noise = output_dists(bf["preds"], f32["preds"])
        pred_dist = output_dists(cap["preds"], eag["preds"])
        shapes = [tuple(x.shape) for x in cap["preds"][0]]
        want = {**{name: 0 for name in COUNTERS}, "conv3x3_pair": 3 * 2 * EVAL_IMAGES,
                **epilogue(forwards=2 * EVAL_IMAGES)}
        row = {"phase": "eval-program", "part": f"validate+predict {pname}", "card": power_limit(),
               "config": "canonical 31M, bf16, pair + kernel masks (DropBlock off in eval), "
                         "random weights seed 0",
               "input": [584, 565], "images": EVAL_IMAGES, "output_shapes": shapes,
               "val_loss": {k: res[k]["val"] for k in EVAL_ROUTES},
               "val_dist_captured_eager": abs(cap["val"] - eag["val"]),
               "val_noise_bf16_f32": val_noise,
               "pred_dist_captured_eager": dict(zip(out_names, pred_dist)),
               "pred_noise_bf16_f32": dict(zip(out_names, pred_noise)),
               "ms_per_forward": cap["times"], "graphs": cap["graphs"], "warm": cap["warm"],
               "seconds": {k: {"validate": res[k]["validate_seconds"],
                               "predict": res[k]["predict_seconds"]} for k in EVAL_ROUTES},
               "peak_gib": {k: res[k]["peak_gib"] for k in EVAL_ROUTES},
               "launches": {"captured": cap["launches"], "eager": eag["launches"]}}
        emit(row)
        if not (cap["launches"] == eag["launches"] == want
                and cap["graphs"] == ["predict", "val"] and cap["warm"] == [1, 1]
                and np.isfinite(cap["val"]) and all(np.isfinite(p[0]).all() for p in cap["preds"])
                and row["val_dist_captured_eager"] <= 2.0 * val_noise
                and all(d <= 2.0 * n for d, n in zip(pred_dist, pred_noise))
                and len(cap["preds"]) == EVAL_IMAGES
                and shapes[0] == ((1, 584, 565, 1) if pname == "none" else (1, 256, 256, 1))):
            raise AssertionError(f"eval-program {pname}: {row}")
        captured_launches.append(cap["launches"])
        if pname == "none":
            reference = {"val": cap["val"], "preds": cap["preds"], "val_noise": val_noise,
                         "pred_noise": pred_noise}
    return added(*captured_launches), reference


def run_eval_predict_at(state) -> dict:
    """(c) base_model_mf.predict_at at 128^2, 256^2 and 584x565 on the same
    images, DropBlock off, through its forward program against
    program=False, compared as (b). Returns the captured route's launches."""
    ds = train_dataset(EVAL_IMAGES, seed=7)
    captured_launches, by_size = [], {}
    for h, w in PREDICT_AT_SIZES:
        res = {}
        for route, (program, overrides) in EVAL_ROUTES.items():
            model = model_for(state, kind=None, **overrides)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with forward_programs() as made, route_epilogue(route, f"predict_at {route}"):
                preds = [p[1:] for p in cli_base_model_mf.predict_at(model, ds, h, w,
                                                                     program=program)]
            seconds = time.perf_counter() - t0
            res[route] = {"preds": preds, "launches": counts(), "seconds": seconds}
            if route == "captured":
                prog, = made

                def forward(im, gt, mask, model=model, h=h, w=w):
                    im, gt, mask = (resize_bilinear(square_pad(t), (h, w))
                                    for t in (im, gt, mask))
                    return model(im) * mask

                res[route]["times"] = forward_times(prog, "predict", forward)
                del prog
            made.clear()
            del model
        cap, eag, bf, f32 = (res[k] for k in ("captured", "eager", "plain_bf16", "plain_f32"))
        noise = output_dists(bf["preds"], f32["preds"])
        dist = output_dists(cap["preds"], eag["preds"])
        want = {**{name: 0 for name in COUNTERS}, "conv3x3_pair": 3 * EVAL_IMAGES,
                **epilogue(forwards=EVAL_IMAGES)}
        by_size[f"{h}x{w}"] = {"dist_captured_eager": dist, "noise_bf16_f32": noise,
                               "ms_per_forward": cap["times"],
                               "seconds": {k: res[k]["seconds"] for k in EVAL_ROUTES},
                               "launches": cap["launches"]["conv3x3_pair"]}
        if not (cap["launches"] == eag["launches"] == want
                and tuple(cap["preds"][0][0].shape) == (1, h, w, 1)
                and all(np.isfinite(p[0]).all() for p in cap["preds"])
                and all(d <= 2.0 * n for d, n in zip(dist, noise))):
            raise AssertionError(f"eval-program predict_at {h}x{w}: {by_size[f'{h}x{w}']}, "
                                 f"launches {cap['launches']} / {eag['launches']}")
        assert_wgmma(f"eval-program predict_at {h}x{w}")
        captured_launches.append(cap["launches"])
    emit({"phase": "eval-program", "part": "predict_at", "card": power_limit(),
          "config": "canonical 31M, bf16, pair, DropBlock off, random weights seed 0",
          "input": [584, 565], "images": EVAL_IMAGES, "by_size": by_size})
    return added(*captured_launches)


BATCHED_EPOCHS, BATCHED_STEPS, BATCHED_SWEEP = 3, 3 * 3, 30


def batched_run(state, program: bool, out_dir: str, mesh=None) -> dict:
    """One route of the batched fit and lr_find (run_eval_batched_fit's):
    a fit at train_batch 2, val_batch 2 of 5 training and 3 validation
    images for BATCHED_EPOCHS epochs, then lr_find at train_batch 2 for
    BATCHED_SWEEP steps from the same weights, under `mesh` when given.
    Returns the history, weights, launches, seconds and peaks and, through
    the step program, its graphs, the collectives one replay of each holds
    and its steps' replayed and eager ms."""
    train_ds, val_ds = train_dataset(5, seed=8), train_dataset(3, seed=9)
    model = train_model(state, nr_steps=BATCHED_STEPS)
    start = flat_params(model)
    cfg = TrainerConfig(max_epochs=BATCHED_EPOCHS, lr=1e-3, momentum=0.99, clip_norm=0.5,
                        auto_lr_find=False, seed=0, verbose=False, train_batch=2, val_batch=2)
    trainer = Trainer(model, POLICIES["none"], cfg, mesh=mesh, device=DEV, program=program)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with step_programs() as made, forward_programs() as made_forward:
        fit_state, history, _ = trainer.fit(train_ds, val_ds, out_dir, params=state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fit_launches = counts()
    assert_wgmma(f"batched fit, program={program}, mesh={mesh is not None}")
    run = {"history": history, "params": flat_params(model), "start": start,
           "launches": fit_launches, "seconds": seconds, "step": fit_state.step,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "programs": len(made), "forward_programs": len(made_forward),
           "captures": [trainer.captures_steps, trainer.captures_forwards]}
    if program:
        prog, fwd = made[0], made_forward[0]

        def eager_step(rows, prog=prog):
            prog.index.zero_()
            prog.step(-1, rows)

        def replay_step(rows, prog=prog):
            prog.index.zero_()
            prog.graphs[(-1, rows)].replay()

        run["graphs"] = sorted(prog.graphs)
        run["step_collectives"] = replayed_collectives(prog.replay_counts)
        run["step_ms"] = {str(rows): {"replayed_ms": time_ms(lambda: replay_step(rows), 10),
                                      "eager_ms": time_ms(lambda: eager_step(rows), 5),
                                      "capture_seconds": prog.capture_seconds[(-1, rows)]}
                          for rows in (2, 1)}
        run["val_ms"] = forward_times(fwd, "val", trainer.eval_step)
        run["forward_graphs"] = len(fwd.graphs)
        del prog, fwd
    made.clear()
    made_forward.clear()

    # lr_find at train_batch 2 from the same weights, its losses read
    # from the step program or the host's steps
    host_losses = []
    step_fn = trainer.train_step

    def spy(*args, step_fn=step_fn, host_losses=host_losses, **kwargs):
        loss = step_fn(*args, **kwargs)
        host_losses.append(loss)
        return loss

    trainer.train_step = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with step_programs() as made:
        suggestion = lr_find(trainer, state, train_ds, None, 0, num_training=BATCHED_SWEEP)
    torch.cuda.synchronize()
    run["lr_find_seconds"] = time.perf_counter() - t0
    run["lr_find_launches"] = counts()
    run["lr_find_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    assert_wgmma(f"batched lr_find, program={program}, mesh={mesh is not None}")
    if program:
        prog, = made
        ran = int(prog.index)
        raw = prog.losses[:ran].cpu().numpy()
        run["lr_find_graphs"] = sorted(prog.graphs)
        run["lr_find_collectives"] = replayed_collectives(prog.replay_counts)
        del prog
    else:
        ran = len(host_losses)
        raw = torch.stack(host_losses).cpu().numpy()
    made.clear()
    run.update(suggestion=suggestion, lr_find_steps=ran, smoothed=smoothed_losses(raw))
    del trainer, model, host_losses, made, made_forward
    return run


def compare_batched(cap: dict, other: dict) -> tuple:
    """A batched run against another route's: the fit's losses' largest
    relative distance (bound 2e-3), the weights' relative L2 (bound 1e-4
    and a tenth of the other fit's movement), lr_find's smoothed losses'
    (2e-3) and the suggestions' grid steps (at most one apart), equal
    step counts and launches. Returns (the numbers, whether they pass)."""
    a = np.array(cap["history"]["train_loss_epoch"] + cap["history"]["val_loss_epoch"])
    b = np.array(other["history"]["train_loss_epoch"] + other["history"]["val_loss_epoch"])
    loss_rel = float(np.max(np.abs(a - b) / np.abs(b)))
    param_rel = rel_l2(cap["params"], other["params"])
    movement = rel_l2(other["params"], other["start"])
    lrs = 1e-8 * (1.0 / 1e-8) ** (np.arange(BATCHED_SWEEP) / (BATCHED_SWEEP - 1))
    grid = [int(np.argmin(np.abs(np.log(lrs) - np.log(r["suggestion"])))) for r in (cap, other)]
    n = min(len(cap["smoothed"]), len(other["smoothed"]))
    smooth_rel = float(np.max(np.abs(cap["smoothed"][:n] - other["smoothed"][:n])
                              / np.abs(other["smoothed"][:n])))
    numbers = {"loss_max_rel": loss_rel, "param_rel_l2": param_rel, "param_movement": movement,
               "lr_find_steps": [cap["lr_find_steps"], other["lr_find_steps"]],
               "suggestion": [cap["suggestion"], other["suggestion"]], "grid_index": grid,
               "smoothed_max_rel": smooth_rel}
    ok = (cap["step"] == other["step"] == BATCHED_STEPS
          and cap["launches"] == other["launches"]
          and cap["lr_find_launches"] == other["lr_find_launches"]
          and np.isfinite(a).all() and loss_rel <= 2e-3 and param_rel <= 1e-4
          and param_rel <= 0.1 * movement
          and cap["lr_find_steps"] == other["lr_find_steps"]
          and len(cap["smoothed"]) == len(other["smoothed"])
          and np.isfinite(cap["smoothed"]).all() and smooth_rel <= 2e-3
          and abs(grid[0] - grid[1]) <= 1)
    return numbers, ok


def run_eval_batched_fit(state) -> tuple:
    """(d) A fit at train_batch 2, val_batch 2 (5 training and 3 validation
    images: steps of 2, 2, 1 rows, validation batches of 2, 1) for 3
    epochs (the partial batch's third step is its first replay, after two
    warm-up steps), then lr_find at train_batch 2 for 30 steps, through the
    step and forward programs against program=False (batched_run,
    compare_batched): losses within 2e-3 relative, parameters within 1e-4
    relative L2 and a tenth of the fit's movement, lr_find's smoothed
    losses within 2e-3 and its suggestion within one step of its grid,
    equal launches (K2 40, K3 6, dx 3, fold 3 per step; K3 3 per validation
    batch). Returns the captured route's fit and lr_find launches and its
    run (dp-nccl's mesh-less reference)."""
    out_root = os.path.join(ROOT, "_runs", "chip_smoke_eval_program")
    shutil.rmtree(out_root, ignore_errors=True)
    runs = {program: batched_run(state, program, os.path.join(out_root, f"program_{program}"))
            for program in (False, True)}
    cap, eag = runs[True], runs[False]
    numbers, ok = compare_batched(cap, eag)
    row = {"phase": "eval-program", "part": "batched fit + lr_find", "card": power_limit(),
           "config": "canonical 31M, bf16, remat, dependent b=7 ramp 0->0.15 over 9 steps, "
                     "pair + kernel masks, SGD 1e-3 momentum 0.99 clip 0.5, train_batch 2, "
                     "val_batch 2",
           "input": [584, 565], "train_images": 5, "val_images": 3,
           "epochs": BATCHED_EPOCHS, "steps": BATCHED_STEPS, "graphs": cap["graphs"],
           "forward_graphs": cap["forward_graphs"], "step_ms": cap["step_ms"],
           "val_ms": cap["val_ms"],
           "fit_seconds": {"captured": cap["seconds"], "eager": eag["seconds"]},
           "peak_gib": {"captured": cap["peak_gib"], "eager": eag["peak_gib"]},
           "loss_max_rel": numbers["loss_max_rel"], "param_rel_l2": numbers["param_rel_l2"],
           "param_movement": numbers["param_movement"],
           "history": {"captured": cap["history"], "eager": eag["history"]},
           "lr_find": {"steps": numbers["lr_find_steps"], "suggestion": numbers["suggestion"],
                       "same_suggestion": cap["suggestion"] == eag["suggestion"],
                       "grid_index": numbers["grid_index"],
                       "smoothed_max_rel": numbers["smoothed_max_rel"],
                       "graphs": cap["lr_find_graphs"],
                       "seconds": [cap["lr_find_seconds"], eag["lr_find_seconds"]],
                       "peak_gib": [cap["lr_find_peak_gib"], eag["lr_find_peak_gib"]]},
           "launches": {"fit": cap["launches"], "lr_find": cap["lr_find_launches"]}}
    emit(row)
    if not (ok and cap["programs"] == 1 and eag["programs"] == 0
            and eag["forward_programs"] == 0
            and cap["graphs"] == [(-1, 1), (-1, 2)] and cap["forward_graphs"] == 2
            and cap["launches"] == train_want(BATCHED_STEPS, BATCHED_EPOCHS * 2)
            and cap["lr_find_graphs"] == [(-1, 1), (-1, 2)]
            and cap["lr_find_launches"] == train_want(cap["lr_find_steps"], 0)):
        raise AssertionError(f"eval-program batched fit: {row}")
    shutil.rmtree(out_root, ignore_errors=True)
    return cap["launches"], cap["lr_find_launches"], cap


ONE_SHOT_SPLITS = (6, 20)   # the README's DRIVE validation and test splits


def run_eval_one_shot(state) -> dict:
    """(e) One-shot evaluation at 584x565 on ONE_SHOT_SPLITS' 6 validation
    and 20 test images, each run through a new forward program (one eager
    forward, one capture, 24 replays) against program=False, in the order
    eager, captured, captured, eager: base_model_mf.evaluate_at end to end
    (final_test_metrics' metrics and files included), and Trainer.predict's
    forwards over both splits (the forwards of final_test_metrics in
    `training -mode test`). Prints each run's seconds, the captures'
    seconds and the seconds of one run of the collector, which every
    capture starts with (ops/cuda/launches.py::capture). Returns the
    captured runs' launches."""
    val_ds, test_ds = (train_dataset(n, seed=11 + i) for i, n in enumerate(ONE_SHOT_SPLITS))
    images = sum(ONE_SHOT_SPLITS)
    out_root = os.path.join(ROOT, "_runs", "chip_smoke_one_shot")
    want = {**{name: 0 for name in COUNTERS}, "conv3x3_pair": 3 * images,
            **epilogue(forwards=images)}
    paths = ("evaluate_at", "predict")
    seconds = {p: {"captured": [], "eager": []} for p in paths}
    capture_s = {p: [] for p in paths}
    collect_s, captured_launches = [], []
    for program in (False, True, True, False):
        route = "captured" if program else "eager"
        for path in paths:
            if path == "evaluate_at":
                model = model_for(state, kind=None)

                def run(model=model, program=program):
                    shutil.rmtree(out_root, ignore_errors=True)
                    cli_base_model_mf.evaluate_at(model, val_ds, test_ds, 584, 565, out_root,
                                                  program=program)
                    return images
            else:
                trainer = Trainer(train_model(state), POLICIES["none"],
                                  TrainerConfig(verbose=False), device=DEV, program=program)

                def run(trainer=trainer):
                    return sum(1 for ds in (val_ds, test_ds) for _ in trainer.predict(None, ds))
            if program:
                t0 = time.perf_counter()
                gc.collect()
                collect_s.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with forward_programs() as made:
                done = run()
            torch.cuda.synchronize()
            seconds[path][route].append(time.perf_counter() - t0)
            got = counts()
            assert_wgmma(f"eval-program one-shot {path} {route}")
            if program:
                prog, = made
                capture_s[path].append(sum(prog.capture_seconds.values()))
                if not (len(prog.graphs) == 1 and sum(prog.warm.values()) == 1):
                    raise AssertionError(f"one-shot {path}: graphs {list(prog.graphs)}, "
                                         f"warm {prog.warm}")
                captured_launches.append(got)
                del prog
            made.clear()
            if not (done == images and got == want):
                raise AssertionError(f"one-shot {path} {route}: {done} images, launches {got}")
    shutil.rmtree(out_root, ignore_errors=True)
    mean = {p: {r: float(np.mean(v)) for r, v in seconds[p].items()} for p in paths}
    emit({"phase": "eval-program", "part": "one-shot", "card": power_limit(),
          "config": "canonical 31M, bf16, pair, DropBlock off, random weights seed 0",
          "input": [584, 565], "splits": list(ONE_SHOT_SPLITS), "order": "eager, captured, "
          "captured, eager", "seconds": seconds, "mean_seconds": mean,
          "captured_minus_eager": {p: mean[p]["captured"] - mean[p]["eager"] for p in paths},
          "capture_seconds": capture_s, "collect_seconds": collect_s})
    return added(*captured_launches)


def check_failed_capture(state) -> None:
    """A capture that the card refuses raises out of Trainer.validate, and
    nothing goes back to the host's forwards: a validation whose forward
    reads its loss on the host (a synchronisation, which a capture
    forbids) runs its first image eagerly (3 K3 launches, the failed
    capture's taken back) and raises at the second's capture; the card
    then runs a validation through a new program. It runs last: PyTorch's
    caching allocator never ends a capture that failed, and from then on
    holds every block freed in the process (run before the later phases,
    it ran one of them out of the card's memory)."""
    ds = train_dataset(2, seed=7)
    trainer = Trainer(train_model(state), POLICIES["none"], TrainerConfig(verbose=False),
                      device=DEV)
    eval_step = trainer.eval_step

    def host_read(im, gt, mask):
        loss = eval_step(im, gt, mask)
        float(loss)
        return loss

    trainer.eval_step = host_read
    reset_counts()
    try:
        trainer.validate(None, ds)
    except RuntimeError as e:
        error = f"{type(e).__name__}: {e}"
    else:
        raise AssertionError("a capture holding a host read did not raise")
    got = counts()
    prog = trainer._forward
    if (prog.graphs or sum(prog.warm.values()) != 1
            or got != {**{name: 0 for name in COUNTERS}, "conv3x3_pair": 3,
                       **epilogue(forwards=1)}):
        raise AssertionError(f"failed capture: graphs {list(prog.graphs)}, warm {prog.warm}, "
                             f"launches {got} (the warm-up's alone expected)")
    del prog, trainer
    after = Trainer(train_model(state), POLICIES["none"], TrainerConfig(verbose=False),
                    device=DEV)
    loss = after.validate(None, ds)
    if not (np.isfinite(loss) and len(after._forward.graphs) == 1):
        raise AssertionError(f"validation after a failed capture: {loss}")
    emit({"phase": "eval-program", "part": "failed-capture", "raised": error[:300],
          "launches_before_the_raise": got, "validation_after": loss})


def run_eval_program(state) -> dict:
    """Phase `eval-program`: the trainer's and base_model_mf's forwards and
    the batched steps through their programs against the host's. Returns
    each part's launches, and the mesh-less references that dp-nccl holds
    its mesh programs against."""
    forwards, forward_ref = run_eval_trainer_forwards(state)
    predict_at = run_eval_predict_at(state)
    fit, sweep, batched_ref = run_eval_batched_fit(state)
    one_shot = run_eval_one_shot(state)
    return ({"eval_program_validate_predict": forwards, "eval_program_predict_at": predict_at,
             "eval_program_batched_fit": fit, "eval_program_batched_lr_find": sweep,
             "eval_program_one_shot": one_shot},
            {"forwards": forward_ref, "batched": batched_ref})


# --- data parallelism -------------------------------------------------------

DP_ROOT = os.path.join(ROOT, "_runs", "chip_smoke_dp")
DP_LR = 1e-3


def check_offsets() -> None:
    """K1 and K2 at a sample offset: the n-sample launch at offset k against
    the plain version at offset k and against rows [k, k+n) of the full
    launch, all bit for bit (masks, keep counts, K1's output), at the MC
    split (16 -> 8 at offset 8) and the train split (2 -> 1 at offset 1)."""
    for full_n, k, n in ((CHUNK, 8, 8), (2, 1, 1)):
        key = keys(11 + k)
        mask, keep = dbk.dropblock_mask((full_n, H, W, 64), key, GAMMA, BLOCK)
        part = (n, H, W, 64)
        m, kp = dbk.dropblock_mask(part, key, GAMMA, BLOCK, sample_offset=k)
        pm, pkp = dbk.dropblock_mask_plain(part, key, GAMMA, BLOCK, sample_offset=k)
        k2 = {"rows": torch.equal(m, mask[k:k + n]) and torch.equal(kp, keep[k:k + n]),
              "plain": torch.equal(m, pm) and torch.equal(kp, pkp)}
        del mask, m, pm
        x = activation(full_n, 64, seed=5 + k)
        ab = gn_ab(x)
        out, keep1 = dbk.dropblock_fused_apply(x, ab, key, GAMMA, BLOCK)
        xs, abs_ = x[k:k + n].contiguous(), ab[:, k:k + n].contiguous()
        o, kp1 = dbk.dropblock_fused_apply(xs, abs_, key, GAMMA, BLOCK, sample_offset=k)
        po, pkp1 = dbk.dropblock_fused_apply_plain(xs, abs_, key, GAMMA, BLOCK, sample_offset=k)
        k1 = {"rows": torch.equal(o, out[k:k + n]) and torch.equal(kp1, keep1[k:k + n]),
              "plain": torch.equal(o, po) and torch.equal(kp1, pkp1)}
        torch.cuda.synchronize()
        emit({"phase": "dp-offsets", "full": [full_n, H, W, 64], "offset": k, "n": n,
              "K2_bit_equal": k2, "K1_bit_equal": k1,
              "keep_fraction": (kp / (H * W * 64)).tolist()})
        if not all(k1.values()) or not all(k2.values()):
            raise AssertionError(f"K1/K2 at offset {k}: K1 {k1}, K2 {k2}")
        del x, out, o, po


def wall_ms(fn, iters: int) -> float:
    """Host clock per call around calls that end in a synchronize (a step
    or a collective: the time the rank waits for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])


def dp_step(state, batch, site_keys, mesh, **overrides):
    """One train step of the canonical train model (remat, dependent b=7 at
    step 7 of the ramp, p = 0.15, clip 0.5) on the global batch of 2; under
    `mesh` on this rank's rows. Returns (loss, params before, after, the
    momentum trace)."""
    model = train_model(state, **overrides)
    cfg = TrainerConfig(lr=DP_LR, momentum=0.99, clip_norm=0.5, auto_lr_find=False,
                        train_batch=2, verbose=False)
    trainer = Trainer(model, POLICIES["none"], cfg, mesh=mesh, device=DEV)
    st = trainer.create_state(None, DP_LR)
    st.step = 7
    before = flat_params(model)
    rows = batch if mesh is None else shard_batch(batch, mesh)
    loss = float(trainer.train_step(st, *rows, DP_LR, site_keys=site_keys))
    trace = torch.cat([v.reshape(-1) for v in st.momentum_buffers()])
    return loss, before, flat_params(model), trace


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def dp_rank() -> dict:
    """One of two gloo ranks sharing the card (parallel/launch.py). Rank 1
    starts from other weights: the trainer hands every rank rank 0's.
    1. One data-parallel train step in float32 and in bf16 (kernel routes),
       the ranks' parameters and momentum compared by float64 checksums;
       rank 0 also runs the one-process steps on the global batch (the same
       route in float32, the plain routes in bf16 and float32).
    2. Trainer.fit, 1 epoch of 4 images at train_batch 2 (4 validation
       images, 2 a rank), with its launches and the checkpoint rank 0
       alone writes, and the route it took: under gloo the step program
       steps eagerly (no graph), the validation forward is captured (its
       second batch replays); then the step's and the gradient
       all-reduce's wall times.
    3. The split MC engine: 48 members, chunk 16, K1 at offsets 0/8, its
       body chunks through its program, stepped eagerly under gloo.
    Returns rank 0's records and counts."""
    torch.backends.cudnn.allow_tf32 = False  # as main() sets them for the references
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(device=DEV)
    rank = mesh.rank
    state = base_state()
    mine = state if rank == 0 else {k: v + 1.0 for k, v in state.items()}
    ds = train_dataset(2, seed=3)
    batch = tuple(torch.as_tensor(a, device=DEV) for a in ds[np.arange(2)])
    site_keys = tunet.draw_site_keys(TRAIN_SITES, torch.Generator().manual_seed(4)).to(DEV)
    out = {}

    # 1. the step
    f32 = dp_step(mine, batch, site_keys, mesh, dtype=torch.float32)
    bf16 = dp_step(mine, batch, site_keys, mesh)
    sums = torch.tensor([[float(t.double().sum()) for t in (*f32[2:], *bf16[2:])]],
                        dtype=torch.float64, device=DEV)
    sums = all_gather(sums, mesh)
    if rank == 0:
        ref = dp_step(state, batch, site_keys, None, dtype=torch.float32)
        with plain_epilogue("dp plain bf16 step"):
            plain_bf16 = dp_step(state, batch, site_keys, None, conv_impl="torch",
                                 mask_impl="elementwise")
        with plain_epilogue("dp plain float32 step"):
            plain_f32 = dp_step(state, batch, site_keys, None, conv_impl="torch",
                                mask_impl="elementwise", dtype=torch.float32)
        upd = {name: r[2] - r[1] for name, r in (("dp_bf16", bf16), ("plain_bf16", plain_bf16),
                                                 ("plain_f32", plain_f32))}
        params_close = torch.allclose(f32[2], ref[2], rtol=2e-4, atol=2e-6)
        out["step"] = {
            "loss_f32_dp": f32[0], "loss_f32_one_process": ref[0],
            "loss_f32_rel": abs(f32[0] - ref[0]) / abs(ref[0]),
            "params_f32_max_abs": float((f32[2] - ref[2]).abs().max()),
            "params_f32_within_rtol_2e-4_atol_2e-6": params_close,
            "loss_bf16_dp": bf16[0], "loss_plain_bf16": plain_bf16[0],
            "loss_plain_f32": plain_f32[0],
            "update_rel_l2_dp_bf16_vs_plain_bf16": rel_l2(upd["dp_bf16"], upd["plain_bf16"]),
            "update_rel_l2_plain_bf16_vs_f32": rel_l2(upd["plain_bf16"], upd["plain_f32"]),
            "checksums_by_rank": sums.tolist(),
            "ranks_bit_identical": bool(torch.equal(sums[0], sums[1]))}
        del ref, plain_bf16, plain_f32, upd
    del f32, bf16

    # 2. fit, then the step and the all-reduce alone
    train_ds, val_ds = train_dataset(4, seed=1), train_dataset(4, seed=2)
    model = train_model(mine)
    cfg = TrainerConfig(max_epochs=1, lr=DP_LR, momentum=0.99, clip_norm=0.5,
                        auto_lr_find=False, seed=0, verbose=False, train_batch=2)
    trainer = Trainer(model, POLICIES["none"], cfg, mesh=mesh, device=DEV)
    model_info = os.path.join(DP_ROOT, f"rank{rank}", "model_info")
    reset_counts()
    t0 = time.perf_counter()
    with step_programs() as made, forward_programs() as made_forward:
        fit_state, history, keeper = trainer.fit(train_ds, val_ds, model_info, params=mine)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - t0
    fit_counts, fit_steps = counts(), fit_state.step
    assert_wgmma(f"dp fit rank {rank}")
    # gloo: the steps take the table route eagerly, the forwards capture
    route = {"backend": mesh.backend, "captures_steps": trainer.captures_steps,
             "captures_forwards": trainer.captures_forwards,
             "step_programs": [(p.captures, p.at, len(p.graphs)) for p in made],
             "forward_graphs": [sorted(role for role, _ in p.graphs) for p in made_forward]}
    made.clear()
    made_forward.clear()
    rows = shard_batch(batch, mesh)
    step_ms = wall_ms(lambda: trainer.train_step(fit_state, *rows, DP_LR), 3)
    flat = torch.zeros(sum(p.numel() for p in fit_state.params), device=DEV)
    allreduce_ms = wall_ms(lambda: all_reduce_grads_([flat], mesh), 3)
    times = all_gather(torch.tensor([[step_ms, allreduce_ms, fit_seconds]], dtype=torch.float64,
                                    device=DEV), mesh)
    out["fit"] = {"launches": fit_counts, "history": history, "step": fit_steps, "route": route,
                  "kept": None if keeper is None else os.listdir(model_info),
                  "step_ms_by_rank": times[:, 0].tolist(),
                  "grad_allreduce_ms_by_rank": times[:, 1].tolist(),
                  "fit_seconds_by_rank": times[:, 2].tolist(),
                  "grad_allreduce_mb": flat.numel() * 4 / 1e6}
    del trainer, model, fit_state, flat

    # 3. the split MC engine, on the weights and generator of run_slice
    im, gt, mask = synthetic_image()
    engine = MCDropBlockEngine(model_for(state), num_iterations=48, return_num=4, chunk=CHUNK,
                               device=DEV, generator=torch.Generator().manual_seed(1),
                               mesh=mesh)
    engine.predict(im, gt, mask, P_DROP)  # the warm-up call run_slice makes
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mean, std, saved, *_ = engine.predict(im, gt, mask, P_DROP)
    torch.cuda.synchronize()
    out["mc"] = {"launches": counts(), "seconds": time.perf_counter() - t0,
                 "outputs": tuple(t.cpu() for t in (mean, std, saved)),
                 "route": {"program": engine.program, "captures": engine.captures,
                           "graphs": [p.graph is not None for p in engine.programs.values()]}}
    assert_wgmma(f"dp MC rank {rank}")
    return out


def run_dp_phase(mc_slice: dict) -> dict:
    """The `dp` phase: two gloo ranks on this one card (NCCL refuses two
    ranks on one card) run dp_rank; the checks of its records. Returns the
    launch counts of rank 0's fit and MC run."""
    shutil.rmtree(DP_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    got = launch.spawn(dp_rank, (), [f"cuda:{DEV.index or 0}"] * 2, backend="gloo")
    seconds = time.perf_counter() - t0
    step, fit, mc = got["step"], got["fit"], got["mc"]
    ok_step = (step["loss_f32_rel"] <= 2e-5 and step["params_f32_within_rtol_2e-4_atol_2e-6"]
               and step["update_rel_l2_dp_bf16_vs_plain_bf16"]
               <= 2.0 * step["update_rel_l2_plain_bf16_vs_f32"]
               and step["ranks_bit_identical"])
    emit({"phase": "dp-train", "ranks": 2, "backend": "gloo", "device": "one card, shared",
          "config": "canonical 31M, remat, dependent b=7 at step 7 of the 0->0.15 ramp, "
          "clip 0.5, global batch 2 (1 row per rank)", **step})
    if not ok_step:
        raise AssertionError(f"dp step: {step}")
    steps, val_per_rank = 2, 2
    want = train_want(steps, val_per_rank)
    rank1_dir = os.path.join(DP_ROOT, "rank1")
    emit({"phase": "dp-fit", "card": power_limit(), "launches_rank0": fit["launches"],
          "history": fit["history"],
          "kept_rank0": fit["kept"], "rank1_wrote": os.path.exists(rank1_dir),
          "step_ms_by_rank": fit["step_ms_by_rank"],
          "grad_allreduce_ms_by_rank": fit["grad_allreduce_ms_by_rank"],
          "grad_allreduce_mb": fit["grad_allreduce_mb"],
          "fit_seconds_by_rank": fit["fit_seconds_by_rank"], "route_rank0": fit["route"]})
    eager_tables = {"backend": "gloo", "captures_steps": False, "captures_forwards": True,
                    "step_programs": [(False, steps, 0)], "forward_graphs": [["val"]]}
    if fit["route"] != eager_tables:
        raise AssertionError(f"dp fit under gloo: route {fit['route']}, expected the eager "
                             f"table route and captured forwards {eager_tables}")
    if fit["launches"] != want or fit["step"] != steps:
        raise AssertionError(f"dp fit launches {fit['launches']}, expected {want}")
    if not (fit["kept"] and len(fit["kept"]) == 1) or os.path.exists(rank1_dir):
        raise AssertionError(f"dp fit: rank 0 kept {fit['kept']}, rank 1 wrote "
                             f"{os.path.exists(rank1_dir)}")
    if not all(np.isfinite(fit["history"]["train_loss_epoch"] + fit["history"]["val_loss_epoch"])):
        raise AssertionError(f"dp fit history {fit['history']}")

    forwards = 4  # the saved 4 and chunks of 16, 16 and 12: each split over the ranks
    want_mc = {**{name: 0 for name in COUNTERS}, "dropblock_fused_apply": 22 * forwards,
               "conv3x3_pair": 3 * forwards, **epilogue(k1_forwards=forwards)}
    diffs = {name: float((a - b).abs().max())
             for name, a, b in zip(("mean", "std", "saved"), mc["outputs"], mc_slice["outputs"])}
    gate = 2.0 * mc_slice["bf16_noise"]
    emit({"phase": "dp-mc", "members": 48, "chunk": CHUNK, "launches_rank0": mc["launches"],
          "seconds": mc["seconds"], "max_abs_vs_one_process": diffs,
          "gate_twice_plain_bf16_vs_f32": gate, "route_rank0": mc["route"]})
    if mc["route"] != {"program": True, "captures": False, "graphs": [False]}:
        raise AssertionError(f"dp MC under gloo: route {mc['route']}, expected the program "
                             "stepped eagerly")
    if mc["launches"] != want_mc or max(diffs.values()) > gate:
        raise AssertionError(f"dp MC: launches {mc['launches']} (want {want_mc}), "
                             f"differences {diffs} against {gate}")
    check_outputs(*(t.to(DEV) for t in mc["outputs"]), 4)
    shutil.rmtree(DP_ROOT)
    emit({"phase": "dp", "seconds": seconds})
    return {"dp_train": fit["launches"], "dp_mc": mc["launches"]}


def check_nccl_step(state, mesh) -> None:
    """NCCL at world size 1: the trainer's data-parallel step bit-equal to the
    plain trainer's step (cuDNN convs in deterministic mode, the K2 masks),
    so the NCCL route of every collective in the step runs on the card."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ds = train_dataset(1, seed=3)
        batch = tuple(torch.as_tensor(a, device=DEV) for a in ds[np.arange(1)])
        site_keys = tunet.draw_site_keys(TRAIN_SITES, torch.Generator().manual_seed(4)).to(DEV)
        runs = {}
        for name, m in (("plain", None), ("nccl", mesh), ("plain_again", None)):
            model = train_model(state, conv_impl="torch")
            cfg = TrainerConfig(lr=DP_LR, momentum=0.99, clip_norm=0.5, auto_lr_find=False,
                                verbose=False)
            trainer = Trainer(model, POLICIES["none"], cfg, mesh=m, device=DEV)
            st = trainer.create_state(None, DP_LR)
            st.step = 7
            loss = trainer.train_step(st, *batch, DP_LR, site_keys=site_keys)
            runs[name] = (loss, flat_params(model),
                          torch.cat([v.reshape(-1) for v in st.momentum_buffers()]))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(runs[a], runs[b]))
    rec = {"backend": mesh.backend, "plain_repeats_bit_equal": same("plain", "plain_again"),
           "nccl_bit_equal_plain": same("nccl", "plain"),
           "loss": float(runs["nccl"][0]),
           "params_max_abs": float((runs["nccl"][1] - runs["plain"][1]).abs().max())}
    emit({"phase": "dp-nccl", "world_size": 1, **rec})
    if mesh.backend != "nccl" or not rec["nccl_bit_equal_plain"]:
        raise AssertionError(f"dp-nccl: {rec}")


def replayed_collectives(counts_by_key: dict) -> dict:
    """{str(key): {collective: calls}} of a program's replay counts
    (ops/cuda/launches.py: the collectives that one replay runs)."""
    return {str(key): {k[11:]: v for k, v in c.items() if k.startswith("collective:")}
            for key, c in counts_by_key.items()}


def run_nccl_batched(state, mesh, ref: dict) -> tuple:
    """eval-program's batched fit and lr_find (batched_run) under the NCCL
    mesh through the captured step programs, against the same under the
    mesh with every step from the host (program=False) and against the
    mesh-less captured run of eval-program (`ref`), each by
    compare_batched; every captured step holds its psums and the gradient
    all-reduce. Returns the captured fit's and lr_find's launches."""
    out_root = os.path.join(ROOT, "_runs", "chip_smoke_dp_nccl")
    shutil.rmtree(out_root, ignore_errors=True)
    runs = {program: batched_run(state, program, os.path.join(out_root, f"program_{program}"),
                                 mesh) for program in (False, True)}
    cap, host = runs[True], runs[False]
    vs_host, ok_host = compare_batched(cap, host)
    vs_meshless, ok_meshless = compare_batched(cap, ref)
    collectives = {"fit": cap["step_collectives"], "lr_find": cap["lr_find_collectives"]}
    held = all(c.get("psum", 0) >= 1 and c.get("all_reduce_grads", 0) == 1
               for part in collectives.values() for c in part.values())
    row = {"phase": "dp-nccl", "part": "batched fit + lr_find", "card": power_limit(),
           "world_size": 1, "backend": mesh.backend, "captures": cap["captures"],
           "config": "canonical 31M, bf16, remat, dependent b=7 ramp 0->0.15 over 9 steps, "
                     "pair + kernel masks, SGD 1e-3 momentum 0.99 clip 0.5, train_batch 2, "
                     "val_batch 2, 5 + 3 images, 3 epochs (steps of 2, 2, 1 rows), "
                     f"lr_find {BATCHED_SWEEP} steps",
           "graphs": cap["graphs"], "lr_find_graphs": cap["lr_find_graphs"],
           "collectives_per_replay": collectives, "step_ms": cap["step_ms"],
           "val_ms": cap["val_ms"],
           "fit_seconds": {"captured": cap["seconds"], "host": host["seconds"],
                           "meshless_captured": ref["seconds"]},
           "lr_find_seconds": {"captured": cap["lr_find_seconds"],
                               "host": host["lr_find_seconds"],
                               "meshless_captured": ref["lr_find_seconds"]},
           "peak_gib": {"captured": cap["peak_gib"], "host": host["peak_gib"],
                        "meshless_captured": ref["peak_gib"]},
           "vs_host": vs_host, "vs_meshless": vs_meshless,
           "launches": {"fit": cap["launches"], "lr_find": cap["lr_find_launches"]}}
    emit(row)
    if not (ok_host and ok_meshless and held and cap["captures"] == [True, True]
            and host["captures"] == [False, False] and host["programs"] == 0
            and cap["graphs"] == cap["lr_find_graphs"] == [(-1, 1), (-1, 2)]
            and cap["launches"] == train_want(BATCHED_STEPS, BATCHED_EPOCHS * 2)):
        raise AssertionError(f"dp-nccl batched fit: {row}")
    shutil.rmtree(out_root, ignore_errors=True)
    return cap["launches"], cap["lr_find_launches"]


def run_nccl_forwards(state, mesh, ref: dict) -> dict:
    """Trainer.validate and Trainer.predict under the NCCL mesh (eval-
    program's `none` part: EVAL_IMAGES images, the same weights), through
    the forward program against program=False under the mesh and against
    eval-program's mesh-less captured run (`ref`): the loss and predict's
    outputs within twice the plain bf16 route's distance from float32
    there, equal launches. Returns the captured route's launches."""
    ds = train_dataset(EVAL_IMAGES, seed=7)
    res = {}
    for program in (True, False):
        model = train_model(state)
        trainer = Trainer(model, POLICIES["none"], TrainerConfig(verbose=False), mesh=mesh,
                          device=DEV, program=program)
        reset_counts()
        t0 = time.perf_counter()
        val = trainer.validate(None, ds)
        preds = [p[1:] for p in trainer.predict(None, ds)]
        torch.cuda.synchronize()
        res[program] = {"val": val, "preds": preds, "launches": counts(),
                        "seconds": time.perf_counter() - t0,
                        "captures": trainer.captures_forwards,
                        "graphs": sorted(role for role, _ in trainer._forward.graphs)}
        del trainer, model
    cap, host = res[True], res[False]
    names = ("seg", "im", "gt", "mask")
    dists = {"host": (abs(cap["val"] - host["val"]), output_dists(cap["preds"], host["preds"])),
             "meshless": (abs(cap["val"] - ref["val"]), output_dists(cap["preds"], ref["preds"]))}
    want = {**{name: 0 for name in COUNTERS}, "conv3x3_pair": 3 * 2 * EVAL_IMAGES,
            **epilogue(forwards=2 * EVAL_IMAGES)}
    row = {"phase": "dp-nccl", "part": "validate + predict", "card": power_limit(),
           "captures": [cap["captures"], host["captures"]], "graphs": cap["graphs"],
           "val_loss": {"captured": cap["val"], "host": host["val"], "meshless": ref["val"]},
           "val_dist": {k: d[0] for k, d in dists.items()},
           "pred_dist": {k: dict(zip(names, d[1])) for k, d in dists.items()},
           "val_noise_bf16_f32": ref["val_noise"],
           "pred_noise_bf16_f32": dict(zip(names, ref["pred_noise"])),
           "seconds": {"captured": cap["seconds"], "host": host["seconds"]},
           "launches": cap["launches"]}
    emit(row)
    if not (cap["launches"] == host["launches"] == want and cap["captures"]
            and not host["captures"] and cap["graphs"] == ["predict", "val"]
            and np.isfinite(cap["val"])
            and all(d[0] <= 2.0 * ref["val_noise"]
                    and all(x <= 2.0 * n for x, n in zip(d[1], ref["pred_noise"]))
                    for d in dists.values())):
        raise AssertionError(f"dp-nccl forwards: {row}")
    return cap["launches"]


def run_nccl_mc(state, mesh, noise: float) -> dict:
    """The 172-member MC engine (mc-program's) under the NCCL mesh through
    its captured program (the chunk's members and their all_gather in one
    graph), against the same under the mesh with every chunk from the host
    and against the mesh-less captured engine, from one seed: launches
    equal (K1, K3 credited per replay), the statistics within twice the
    plain bf16 route's distance from float32 (`noise`), at least one
    collective in the graph; the replayed and eager chunk ms, the
    capture's seconds, each route's seconds and peaks. Returns the
    captured route's launches."""
    model = model_for(state)
    im, gt, mask = synthetic_image()
    members, ret = 172, 4
    outside, body = split_chunks(members, ret, CHUNK)
    engines = {route: MCDropBlockEngine(model, num_iterations=members, return_num=ret,
                                        chunk=CHUNK, device=DEV, program=route != "host",
                                        mesh=None if route == "meshless" else mesh)
               for route in ("host", "captured", "meshless")}
    forwards = outside + body
    want = {"dropblock_fused_apply": 22 * forwards, "conv3x3_pair": 3 * forwards,
            **epilogue(k1_forwards=forwards)}
    runs = {}
    for route, engine in engines.items():
        def call(engine=engine):
            return engine.predict(im, gt, mask, P_DROP,
                                  generator=torch.Generator().manual_seed(3))[:3]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call()  # the captured routes' warm-up chunk and capture
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outputs = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        expect_launches(f"dp-nccl MC {route}", counts(), want)
        runs[route] = {"outputs": outputs, "seconds": seconds, "captures": engine.captures,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    (prog,) = engines["captured"].programs.values()
    with torch.inference_mode():
        zero = torch.zeros_like(prog.index)

    def chunk(fn):
        def run():
            with torch.inference_mode():
                prog.index.copy_(zero)
                fn()
        return run

    replay_ms = time_ms(chunk(prog.graph.replay), 5)
    eager_ms = time_ms(chunk(prog.step), 3)
    collectives = replayed_collectives({"chunk": prog.replay_counts})["chunk"]
    diffs = {other: {name: float((a - b).abs().max())
                     for name, a, b in zip(("mean", "std", "saved"), runs["captured"]["outputs"],
                                           runs[other]["outputs"])}
             for other in ("host", "meshless")}
    row = {"phase": "dp-nccl", "part": "mc", "card": power_limit(), "members": members,
           "chunk": CHUNK, "return_num": ret, "body_chunks": body,
           "captures": {r: v["captures"] for r, v in runs.items()},
           "collectives_per_replay": collectives, "replay_launches": prog.replay_counts,
           "replayed_chunk_ms": replay_ms, "eager_chunk_ms": eager_ms,
           "capture_seconds": prog.capture_seconds,
           "seconds": {r: v["seconds"] for r, v in runs.items()},
           "passes_per_s": {r: members / v["seconds"] for r, v in runs.items()},
           "peak_gib": {r: v["peak_gib"] for r, v in runs.items()},
           "max_abs_captured_vs": diffs, "gate": 2.0 * noise}
    emit(row)
    if not (runs["captured"]["captures"] and not runs["host"]["captures"]
            and collectives.get("all_gather", 0) >= 1
            and all(d <= 2.0 * noise for part in diffs.values() for d in part.values())):
        raise AssertionError(f"dp-nccl MC: {row}")
    check_outputs(*runs["captured"]["outputs"], ret)
    return {**{name: 0 for name in COUNTERS}, **want}


def run_dp_nccl(state, refs: dict, noise: float) -> dict:
    """Phase `dp-nccl`: one NCCL rank on the card (world size 1; NCCL
    refuses two ranks on one card): the eager mesh step bit-equal to the
    plain step (check_nccl_step), then the mesh programs captured under
    NCCL against the host's routes and the mesh-less programs
    (run_nccl_batched, run_nccl_forwards, run_nccl_mc; `refs` are
    eval-program's mesh-less runs, `noise` the MC gate's). Returns each
    part's launches."""
    multihost_initialize(f"tcp://127.0.0.1:{launch.free_port()}", 1, 0)
    t0 = time.perf_counter()
    try:
        mesh = make_mesh(device=DEV)
        check_nccl_step(state, mesh)
        fit, sweep = run_nccl_batched(state, mesh, refs["batched"])
        forwards = run_nccl_forwards(state, mesh, refs["forwards"])
        mc = run_nccl_mc(state, mesh, noise)
    finally:
        dist.destroy_process_group()
    emit({"phase": "dp-nccl", "seconds": time.perf_counter() - t0})
    return {"dp_nccl_fit": fit, "dp_nccl_lr_find": sweep, "dp_nccl_forwards": forwards,
            "dp_nccl_mc": mc}


# --- the CLIs ---------------------------------------------------------------

CLI_ROOT = os.path.join(ROOT, "_runs", "chip_smoke_cli")
CLI_SPLITS = (("train", 4, True), ("val", 2, True), ("test", 1, False))
CLI_FLAGS = ["--precision", "bf16"]
CLI_CFG = {"dtype": torch.bfloat16}  # the model those flags build (canonical_config)
MC_ITERS, MC_SAVE, ROT_ITERS, ROT_SAVE = 48, 4, 359, 2


def optional_libraries() -> dict:
    """Which of the JAX package's evaluation libraries import here, each in
    a process of its own: the port needs none of them."""
    return {name: subprocess.run([sys.executable, "-c", f"import {name}"],
                                 capture_output=True).returncode == 0
            for name in ("PIL", "pandas", "sklearn", "matplotlib", "msgpack")}


def write_cli_tree(root: str) -> None:
    """An augmented-layout tree of 584x565 PNGs: seeded variants of the
    synthetic image, the disc FOV as every mask, and targets with both
    classes inside the FOV."""
    im, gt, fov = (a[0, ..., 0] for a in synthetic_image())
    inside = gt[fov > 0]
    if not (inside.min() == 0.0 and inside.max() == 1.0):
        raise AssertionError("the synthetic target must hold both classes in the FOV")
    rng = np.random.default_rng(5)
    for split, n, with_targets in CLI_SPLITS:
        kinds = ("images", "masks", "targets") if with_targets else ("images", "masks")
        for kind in kinds:
            os.makedirs(os.path.join(root, split, kind))
        for i in range(n):
            noisy = np.clip(im + 0.05 * rng.standard_normal(im.shape), 0.0, 1.0)
            png.write_png(os.path.join(root, split, "images", f"{i}_image.png"), to_u8(noisy))
            png.write_png(os.path.join(root, split, "masks", f"{i}_mask.png"), to_u8(fov))
            if with_targets:
                png.write_png(os.path.join(root, split, "targets", f"{i}_target.png"), to_u8(gt))


def split_chunks(members: int, saved: int, chunk: int) -> tuple[int, int]:
    """(chunks run from the host, chunks of the device program) of one
    ensemble, in uncertainty/ensemble.py's layout; their sum is its
    batched forwards."""
    layout = chunk_layout(members, chunk, saved)
    return len(layout.sizes) - layout.n_body, layout.n_body


class Stopwatch:
    """Seconds spent inside chosen callables while active, the card awaited
    at each exit; a generator function is timed over each of its items."""

    def __init__(self, targets):
        self.targets = targets  # [(owner, attribute name)]
        self.seconds = 0.0

    def wrap(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

        def timed_items(*args, **kwargs):
            items = fn(*args, **kwargs)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(items)
                except StopIteration:
                    return
                finally:
                    torch.cuda.synchronize()
                    self.seconds += time.perf_counter() - t0
                yield item

        return timed_items if inspect.isgeneratorfunction(fn) else timed

    def __enter__(self):
        self.saved = [(owner, name, getattr(owner, name)) for owner, name in self.targets]
        for owner, name, fn in self.saved:
            setattr(owner, name, self.wrap(fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def cli_files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(base, f), root)
                  for base, _, files in os.walk(root) for f in files)


def check_pt(path: str, shape: tuple) -> torch.Tensor:
    t = torch.load(path)
    if tuple(t.shape) != shape or t.dtype != torch.float32 or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{path}: {t.dtype} {tuple(t.shape)}, expected float32 {shape}")
    return t


def check_metrics_csv(path: str, rows: int) -> list:
    with open(path, newline="") as f:
        table = list(csv.reader(f))
    if table[0] != list(ev_metrics.COLUMNS) or len(table) != rows + 1:
        raise AssertionError(f"{path}: {table}")
    values = [[float(v) for v in row] for row in table[1:]]
    if not np.isfinite(values).all():
        raise AssertionError(f"{path}: non-finite metrics {values}")
    return values


def expect_launches(where: str, got: dict, want: dict) -> None:
    """The launches of a run are `want` (0 for the kernels it omits), and
    every K3 launch ran the wgmma kernel."""
    if got != {**{name: 0 for name in COUNTERS}, **want}:
        raise AssertionError(f"{where}: launches {got}, expected {want}")
    assert_wgmma(where)


def run_cli(name: str, main, argv: list, want: dict) -> tuple:
    """One CLI call through its main(argv): its launch counts (asserted),
    its seconds, the seconds inside the engines (Trainer.fit and .predict,
    the ensembles' predict, base_model_mf's predict_at), in
    final_test_metrics and in load_datasets."""
    engines = Stopwatch([(Trainer, "fit"), (Trainer, "predict"), (MCDropBlockEngine, "predict"),
                         (RotationalEngine, "predict"), (cli_base_model_mf, "predict_at")])
    harness = Stopwatch([(cli_common, "final_test_metrics"), (cli_dropblock, "final_test_metrics"),
                         (cli_base_model_mf, "final_test_metrics")])
    loading = Stopwatch([(cli_common, "load_datasets")])
    reset_counts()
    t0 = time.perf_counter()
    with engines, harness, loading:
        out = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counts()
    expect_launches(f"cli {name}", got, want)
    row = {"command": name, "seconds": seconds, "engine_seconds": engines.seconds,
           "final_test_metrics_seconds": harness.seconds, "load_datasets_seconds": loading.seconds,
           "outside_engines_share": 1.0 - engines.seconds / seconds, "launches": got}
    return out, row


def run_cli_phase() -> dict:
    """The port's three kernel-carrying CLIs at full width and depth
    (canonical 31M, bf16, default routes) on a synthetic 584x565 tree:
    training (train, then test on the kept checkpoint), dropblock_uncertainty
    and rotational_uncertainty -warp shear. Returns each command's launches."""
    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    data, runs = os.path.join(CLI_ROOT, "data"), os.path.join(CLI_ROOT, "runs")
    t0 = time.perf_counter()
    write_cli_tree(data)
    emit({"phase": "cli-data", "splits": {s: n for s, n, _ in CLI_SPLITS}, "input": [584, 565],
          "seconds": time.perf_counter() - t0})
    n_train, n_val, n_test = (n for _, n, _ in CLI_SPLITS)
    cfg = tunet.canonical_config(**CLI_CFG)
    rows, launches = [], {}

    # training -mode train: 1 epoch of n_train steps, n_val validation
    # forwards, then the final metrics' n_test + n_val forwards
    argv = ["-mode", "train", "-data_path", data, "-save_path", os.path.join(runs, "bm"),
            "-num_epochs", "1", "--auto_lr_find", "False", "-lr", "1e-3",
            "--gradient_clip_val", "0.5", "-seed", "0"] + CLI_FLAGS
    forwards = n_val + n_test + n_val
    dest, row = run_cli("training-train", cli_training.main, argv, train_want(n_train, forwards))
    ckpt = find_checkpoint(os.path.join(dest, "model_info"))
    want = [os.path.join("model_info", os.path.basename(ckpt))] + [
        os.path.join("statistics", f) for f in ev_metrics.output_files(n_val, n_test)]
    if cli_files(dest) != sorted(want):
        raise AssertionError(f"training tree {cli_files(dest)}")
    sd, meta = load_model_checkpoint(ckpt, cfg)
    tunet.UNet(cfg, device=DEV).load_state_dict(sd)
    row["metrics"] = check_metrics_csv(
        os.path.join(dest, "statistics", "val_images", "metrics.csv"), n_val)
    for i in range(n_val):
        check_pt(os.path.join(dest, "statistics", "val_images", "tensors", f"image_{i}",
                              "segmentation.pt"), (1, 584, 565))
    row["checkpoint"] = {"file": os.path.basename(ckpt), "meta": meta}
    rows.append(row)
    launches["cli_train"] = row["launches"]

    # training -mode test on the kept checkpoint
    argv = ["-mode", "test", "-model_path", ckpt, "-data_path", data, "-save_path",
            os.path.join(runs, "test"), "-seed", "0"] + CLI_FLAGS
    out, row = run_cli("training-test", cli_training.main, argv,
                       {"conv3x3_pair": 3 * (n_test + n_val),
                        **epilogue(forwards=n_test + n_val)})
    if cli_files(out) != ev_metrics.output_files(n_val, n_test):
        raise AssertionError(f"test tree {cli_files(out)}")
    row["metrics"] = check_metrics_csv(os.path.join(out, "val_images", "metrics.csv"), n_val)
    rows.append(row)
    launches["cli_test"] = row["launches"]

    # dropblock_uncertainty: each val image's ensemble twice (save, then
    # evaluate with fresh masks)
    argv = ["-model_path", ckpt, "-data_path", data, "-save_path", os.path.join(runs, "mc"),
            "-iter_num", str(MC_ITERS), "-chunk", str(CHUNK), "-save_num", str(MC_SAVE),
            "-seed", "0"] + CLI_FLAGS
    mc_forwards = sum(split_chunks(MC_ITERS, MC_SAVE, CHUNK)) * n_val * 2
    out, row = run_cli("dropblock_uncertainty", cli_dropblock.main, argv, {
        "dropblock_fused_apply": TRAIN_SITES * mc_forwards, "conv3x3_pair": 3 * mc_forwards,
        **epilogue(k1_forwards=mc_forwards)})
    want = ["model_ckpt_symlink.ckpt"] + [
        os.path.join("tensors", f"image_{i}", f"{m}.pt") for i in range(n_val)
        for m in ("mean", "std", "tensors")] + [
        os.path.join("statistics", f) for f in ev_metrics.output_files(n_val, 0, True)]
    if cli_files(out) != sorted(want):
        raise AssertionError(f"dropblock_uncertainty tree {cli_files(out)}")
    std_max = []
    for i in range(n_val):
        folder = os.path.join(out, "tensors", f"image_{i}")
        check_pt(os.path.join(folder, "mean.pt"), (1, 1, 584, 565))
        check_pt(os.path.join(folder, "tensors.pt"), (MC_SAVE, 1, 1, 584, 565))
        std_max.append(float(check_pt(os.path.join(folder, "std.pt"), (1, 1, 584, 565)).max()))
    if not min(std_max) > 0:
        raise AssertionError(f"MC std.max() per image {std_max}")
    row.update(forwards=mc_forwards, std_max=std_max, metrics=check_metrics_csv(
        os.path.join(out, "statistics", "val_images", "metrics.csv"), n_val))
    rows.append(row)
    launches["cli_mc"] = row["launches"]

    # rotational_uncertainty -warp shear over all 359 angles
    argv = ["-model_path", ckpt, "-data_path", data, "-save_path", os.path.join(runs, "rot"),
            "-warp", "shear", "-num_iterations", str(ROT_ITERS), "-save_num", str(ROT_SAVE),
            "-chunk", str(CHUNK)] + CLI_FLAGS
    rot_forwards = sum(split_chunks(ROT_ITERS, ROT_SAVE, CHUNK)) * n_val
    rot_want = rotational_launches("shear", *split_chunks(ROT_ITERS, ROT_SAVE, CHUNK))
    out, row = run_cli("rotational_uncertainty-shear", cli_rotational.main, argv,
                       {name: n * n_val for name, n in rot_want.items()})
    want = ["model_ckpt_symlink.ckpt"] + [os.path.join(f"image_{i}", f"{m}.pt")
                                          for i in range(n_val) for m in ("mean", "std", "tensors")]
    if cli_files(out) != sorted(want):
        raise AssertionError(f"rotational_uncertainty tree {cli_files(out)}")
    std_max = []
    for i in range(n_val):
        folder = os.path.join(out, f"image_{i}")
        check_pt(os.path.join(folder, "mean.pt"), (1, 1, 584, 565))
        check_pt(os.path.join(folder, "tensors.pt"), (ROT_SAVE, 1, 1, 584, 565))
        std_max.append(float(check_pt(os.path.join(folder, "std.pt"), (1, 1, 584, 565)).max()))
    if not min(std_max) > 0:
        raise AssertionError(f"rotational std.max() per image {std_max}")
    row.update(forwards=rot_forwards, std_max=std_max)
    rows.append(row)
    launches["cli_rotational_shear"] = row["launches"]
    for row in rows:
        emit({"phase": "cli", "config": "canonical 31M, --precision bf16, default routes "
              "(-conv_impl pair, -mask_impl fused)", "input": [584, 565], **row})
    time_evaluation(data)
    shutil.rmtree(CLI_ROOT)
    return launches


def time_evaluation(data: str) -> None:
    """Host seconds of the evaluation layer at 584x565: reading one PNG of
    the tree (filter 0, the row path), undoing Paeth filters on every row
    (the anti-diagonal path, which PIL-written files take), the FOV metrics
    (AUROC over the disc FOV), each figure."""
    im, gt, fov = synthetic_image()
    seg = np.clip(im + 0.1, 0.0, 1.0)[0]
    out = os.path.join(CLI_ROOT, "evaluation")
    os.makedirs(out)
    timings = {}
    paeth_rows = np.full(584, 4, np.uint8)
    filtered = np.random.default_rng(3).integers(0, 256, (584, 565), dtype=np.uint8)
    calls = {"read_png": lambda: png.read_png(os.path.join(data, "val", "images", "0_image.png")),
             "unfilter_paeth_rows": lambda: png._unfilter(paeth_rows, filtered, 1),
             "get_accuracy_metrics": lambda: ev_metrics.get_accuracy_metrics(seg, gt[0], fov[0]),
             "save_val_example": lambda: ev_artifacts.save_val_example(im[0], seg, gt[0], 1, out),
             "save_contour_map": lambda: ev_artifacts.save_contour_map(seg, gt[0], out),
             "save_overlap_map": lambda: ev_artifacts.save_overlap_map(seg, gt[0], out),
             "save_test_example": lambda: ev_artifacts.save_test_example(im[0], seg, 1, out),
             "save_loss_profile": lambda: ev_artifacts.save_loss_profile(
                 list(np.linspace(0.7, 0.2, 50)), list(np.linspace(0.6, 0.25, 50)), out)}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        fn()
        timings[name] = time.perf_counter() - t0
    emit({"phase": "evaluation-host", "input": [584, 565], "fov_pixels": int((fov > 0).sum()),
          "seconds": timings})


# --- dataset generation and the multi-fidelity CLIs --------------------------

DRIVE_ROOT = os.path.join(ROOT, "_runs", "chip_smoke_drive")
DRIVE_SPLITS = (("training", 5, True), ("test", 2, False))
AUG_MEMBERS, AUG_TRAIN = 36, 8          # one batch of the real generator; -num_train
MF_SIZES = ((128, 128), (256, 256), (584, 565))   # base_model_mf's sweep


def write_raw_tiff(path: str, rgb: np.ndarray) -> None:
    """An uncompressed little-endian RGB TIFF in one strip."""
    h, w, _ = rgb.shape
    entries = [(256, 3, [w]), (257, 3, [h]), (258, 3, [8, 8, 8]), (259, 3, [1]), (262, 3, [2]),
               (273, 4, [0]), (277, 3, [3]), (278, 3, [h]), (279, 4, [rgb.nbytes]), (284, 3, [1])]
    bits_at = 8 + 2 + 12 * len(entries) + 4
    data_at = bits_at + 6
    ifd = struct.pack("<H", len(entries))
    for tag, kind, values in entries:
        if tag == 258:
            field = struct.pack("<I", bits_at)
        elif tag == 273:
            field = struct.pack("<I", data_at)
        else:
            field = struct.pack("<" + ("H" if kind == 3 else "I"), values[0]).ljust(4, b"\0")
        ifd += struct.pack("<HHI", tag, kind, len(values)) + field
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0)
                + struct.pack("<3H", 8, 8, 8) + np.ascontiguousarray(rgb).tobytes())


def write_gray_gif(path: str, gray: np.ndarray) -> None:
    """A GIF of uint8 (H, W) with the identity gray palette whose LZW codes
    stay at 9 bits: literals only, a clear code before every 254 of them."""
    h, w = gray.shape
    n = gray.size
    groups = -(-n // 254)
    codes = np.full(n + groups + 1, 256, np.uint16)       # clear codes ...
    codes[np.arange(n) + np.arange(n) // 254 + 1] = gray.reshape(-1)
    codes[-1] = 257                                        # ... and the end code
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes((len(data[i:i + 255]),)) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + palette + b","
                + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08" + blocks + b"\x00;")


def write_drive_tree(root: str) -> dict:
    """A DRIVE-layout tree at 584x565 from the synthetic image: RGB TIFFs
    (three gains of the image plus noise), the disc FOV as every mask GIF,
    the target as the 1st_manual GIFs. Returns {split: (images, targets or
    None, masks)}, the uint8 arrays written."""
    im, gt, fov = (a[0, ..., 0] for a in synthetic_image())
    rng = np.random.default_rng(8)
    written = {}
    for split, n, manual in DRIVE_SPLITS:
        kinds = ("images", "mask", "1st_manual") if manual else ("images", "mask")
        for kind in kinds:
            os.makedirs(os.path.join(root, split, kind))
        arrays = ([], [] if manual else None, [])
        for i in range(n):
            rgb = np.stack([im * g for g in (0.9, 0.6, 0.3)], axis=-1)
            rgb = (np.clip(rgb + 0.05 * rng.standard_normal(rgb.shape), 0, 1) * 255).round()
            arrays[0].append(rgb.astype(np.uint8))
            write_raw_tiff(os.path.join(root, split, "images", f"{21 + i:02d}_{split}.tif"),
                           arrays[0][-1])
            arrays[2].append((fov * 255).astype(np.uint8))
            write_gray_gif(os.path.join(root, split, "mask", f"{21 + i:02d}_{split}_mask.gif"),
                           arrays[2][-1])
            if manual:
                arrays[1].append((gt * 255).astype(np.uint8))
                write_gray_gif(os.path.join(root, split, "1st_manual", f"{21 + i:02d}_manual1.gif"),
                               arrays[1][-1])
        written[split] = tuple(None if a is None else np.stack(a) for a in arrays)
    return written


def nearest_ties(angles, rot_on, h: int, w: int) -> np.ndarray:
    """(K, H, W) True where a cv2-style rotation's source coordinate, in
    float64 from the float32 radians, lies within 1e-4 of a .5 tie: there
    floor(src + 0.5) may fetch either neighbour (tests/test_torch_augment.py)."""
    a = np.where(rot_on, angles, np.float32(0)).astype(np.float32) * np.float32(np.pi / 180)
    a = a.astype(np.float64)[:, None, None]
    yy = np.arange(h, dtype=np.float64)[:, None] - h / 2
    xx = np.arange(w, dtype=np.float64)[None, :] - w / 2
    near = [np.abs(s - np.floor(s) - 0.5) < 1e-4
            for s in (np.cos(a) * xx - np.sin(a) * yy + w / 2, np.sin(a) * xx + np.cos(a) * yy + h / 2)]
    return near[0] | near[1]


def differ_off_ties(got, want, ties, what: str) -> dict:
    ties = np.broadcast_to(ties.reshape(ties.shape + (1,) * (got.ndim - ties.ndim)), got.shape)
    differ = got != want
    if (differ & ~ties).any():
        raise AssertionError(f"{what}: {int((differ & ~ties).sum())} pixels differ off the ties")
    return {"ties": int(ties.sum()), "differ_at_ties": int(differ.sum())}


def check_augment_batch(drive) -> None:
    """One source image's 36 augments on the card and on the CPU (the plain
    route, the same plan): the card's uint8 outputs equal the CPU's but at
    proven ties (the gray image within 0.05 before rounding, and rounding
    apart only within 0.05 of a .5 boundary; targets and masks apart only
    at nearest ties)."""
    im, gt, mask = drive[0]
    plan = data_augment._plan(np.random.default_rng(7), AUG_MEMBERS)
    plan[0][:4], plan[1][:4] = (0.0, 90.0, -90.0, 180.0), True
    outs, seconds = {}, {}
    for where, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        args = data_augment._on_device(im, gt, mask, dev)
        data_augment._augment_batch(*args, *plan)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = data_augment._augment_batch(*args, *plan)
        torch.cuda.synchronize()
        seconds[where] = time.perf_counter() - t0
        outs[where] = [t.cpu().numpy() for t in out]
        if where == "card":
            peak = torch.cuda.max_memory_allocated() / 2**30
    (card_im, card_gt, card_mask), (cpu_im, cpu_gt, cpu_mask) = outs["card"], outs["cpu"]
    float_err = float(np.abs(card_im - cpu_im).max())
    if not float_err <= 0.05:
        raise AssertionError(f"augment image: card vs CPU {float_err} > 0.05")

    def u8(a):
        return np.clip(np.round(a), 0, 255).astype(np.uint8)

    h, w = gt.shape
    near = nearest_ties(plan[0], plan[1], h, w)
    rounding = np.abs(cpu_im - np.floor(cpu_im) - 0.5) <= 0.05
    emit({"phase": "drive-augment-batch", "members": AUG_MEMBERS, "input": [h, w],
          "image_max_abs": float_err,
          "image_u8": differ_off_ties(u8(card_im), u8(cpu_im), rounding, "augment image"),
          "target_u8": differ_off_ties(u8(card_gt), u8(cpu_gt), near, "augment target"),
          "mask_u8": differ_off_ties(u8(card_mask), u8(cpu_mask), near, "augment mask"),
          "card_seconds": seconds["card"], "cpu_seconds": seconds["cpu"], "card_peak_gib": peak})


def run_drive_augment_phase() -> str:
    """The DRIVE reader and the generator: a synthetic 584x565 DRIVE tree,
    one 36-member batch held card against CPU, then create_augmentations
    -num_train 8 through its main(argv) on the card. Returns the tree."""
    shutil.rmtree(DRIVE_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    written = write_drive_tree(os.path.join(DRIVE_ROOT, "drive"))
    write_seconds = time.perf_counter() - t0
    # load_drive (read_tiff, read_gif) gives back what was written
    t0 = time.perf_counter()
    loaded = {split: load_drive(os.path.join(DRIVE_ROOT, "drive"), split) for split in written}
    read_seconds = time.perf_counter() - t0
    for split, arrays in written.items():
        got = (loaded[split].images, loaded[split].targets, loaded[split].masks)
        for kind, a, b in zip(("images", "targets", "masks"), got, arrays):
            if not (a is None and b is None or np.array_equal(a, b)):
                raise AssertionError(f"load_drive {split} {kind}: not the arrays written")
    emit({"phase": "drive-data", "splits": {s: n for s, n, _ in DRIVE_SPLITS},
          "input": [584, 565], "write_seconds": write_seconds, "load_drive_seconds": read_seconds})
    check_augment_batch(loaded["training"])

    dest = os.path.join(DRIVE_ROOT, "aug")
    argv = ["-data_root", os.path.join(DRIVE_ROOT, "drive"), "-dest", dest, "-seed", "1234",
            "-num_train", str(AUG_TRAIN)]
    device = Stopwatch([(data_augment, "_augment_batch")])
    writes = Stopwatch([(data_augment, "_save_u8")])
    reads = Stopwatch([(data_augment, "load_drive")])
    reset_counts()
    t0 = time.perf_counter()
    with device, writes, reads:
        out = cli_augment.main(argv)
    seconds = time.perf_counter() - t0
    expect_launches("create_augmentations", counts(), {})
    n_train = 3 * AUG_TRAIN   # int(5 * 0.7) sources
    want = [os.path.join(split, kind, f"{i}_{kind[:-1]}.png")
            for split, n in (("train", n_train), ("val", 2))
            for kind in ("images", "targets", "masks") for i in range(n)]
    want += [os.path.join("test", kind, f"{i:02d}_{kind[:-1]}.png")
             for kind in ("images", "masks") for i in (1, 2)]
    if out != dest or cli_files(out) != sorted(want):
        raise AssertionError(f"create_augmentations tree {cli_files(out)}")
    train = load_split(os.path.join(out, "train"))
    if train.images.shape != (n_train, 584, 565, 1):
        raise AssertionError(f"train split {train.images.shape}")
    emit({"phase": "drive-augment", "command": "create_augmentations -num_train 8",
          "input": [584, 565], "triples": {"train": n_train, "val": 2, "test": 2},
          "seconds": seconds, "device_batch_seconds": device.seconds,
          "png_write_seconds": writes.seconds, "load_drive_seconds": reads.seconds,
          "png_files": len(want)})
    return out


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|; NaN when `want` is zero or not finite."""
    scale = float(want.float().abs().max())
    if not (0.0 < scale < float("inf")):
        return float("nan")
    return float((got.float() - want.float()).abs().max()) / scale


def check_k3_sizes() -> None:
    """K3 and its dx at the multi-fidelity sizes (32^2, 128^2, 256^2 and
    300x200 autopadded to 304x208), 64 and 128 input channels, batch 1,
    against the plain version (K3's tolerances), each on wgmma; then one
    DropBlock-free forward of the canonical model at 300x200: 3 K3
    launches, every other 3x3 conv on cuDNN."""
    rows = []
    for h, w in ((32, 32), (128, 128), (256, 256), (304, 208)):
        for cin in (64, 128):
            wts = conv_weights(cin, 64)
            g = torch.Generator(device=DEV).manual_seed(h + cin)
            x = torch.randn((1, h, w, cin), device=DEV, generator=g).to(torch.bfloat16)
            dy = torch.randn((1, h, w, 64), device=DEV, generator=g).to(torch.bfloat16)
            y, s1, s2 = pc.conv3x3_pair(x, wts, stats=True)
            path = pc.conv3x3_pair.path
            dx, _ = pc.conv3x3_pair_dx(dy, wts)
            if path != "wgmma" or pc.conv3x3_pair_dx.path != "wgmma":
                raise AssertionError(f"K3 at {h}x{w}x{cin}: {path}, dx {pc.conv3x3_pair_dx.path}")
            ry = pc.conv3x3_pair_plain(x, wts)
            _, r1, r2 = pc.conv3x3_pair_plain(x.float(), wts.float(), stats=True)
            rdx, _ = pc.conv3x3_pair_dx_plain(dy, wts)
            rel = {"y": max_rel(y, ry), "dx": max_rel(dx, rdx),
                   "sums": max(max_rel(s1, r1), max_rel(s2, r2))}
            # written so that a NaN fails
            if not (rel["y"] <= 1e-2 and rel["dx"] <= 1e-2 and rel["sums"] <= 1e-3):
                raise AssertionError(f"K3 at {h}x{w}x{cin}: {rel}")
            rows.append({"shape": [1, h, w, cin], **rel})
    model = model_for(base_state(), kind=None)
    reset_counts()
    with torch.inference_mode():
        seg = model(torch.rand((1, 300, 200, 1), device=DEV))
    torch.cuda.synchronize()
    expect_launches("forward at 300x200", counts(), {"conv3x3_pair": 3, **epilogue(forwards=1)})
    if seg.shape != (1, 300, 200, 1) or not bool(torch.isfinite(seg).all()):
        raise AssertionError(f"forward at 300x200: {tuple(seg.shape)}")
    emit({"phase": "K3-sizes", "rows": rows, "forward_300x200_launches": counts()})


def check_cli_tree(where: str, out: str, n_val: int, n_test: int, side) -> list:
    """The final-metrics tree under `out`, the segmentation shapes (1, *side)
    and a finite metrics.csv; returns its values."""
    if cli_files(out) != ev_metrics.output_files(n_val, n_test):
        raise AssertionError(f"{where} tree {cli_files(out)}")
    for i in range(n_val):
        check_pt(os.path.join(out, "val_images", "tensors", f"image_{i}", "segmentation.pt"),
                 (1, *side))
    return check_metrics_csv(os.path.join(out, "val_images", "metrics.csv"), n_val)


def run_trained_cli(name: str, main, argv: list, want: dict, n_val: int, n_test: int, side,
                    cfg) -> tuple:
    """A -mode train command: its launches, the kept checkpoint (loaded back
    strictly) and the statistics tree. Returns (checkpoint, row)."""
    dest, row = run_cli(name, main, argv, want)
    ckpt = find_checkpoint(os.path.join(dest, "model_info"))
    if cli_files(os.path.join(dest, "model_info")) != [os.path.basename(ckpt)]:
        raise AssertionError(f"{name}: model_info {cli_files(os.path.join(dest, 'model_info'))}")
    row["metrics"] = check_cli_tree(name, os.path.join(dest, "statistics"), n_val, n_test, side)
    sd, meta = load_model_checkpoint(ckpt, cfg)
    tunet.UNet(cfg, device=DEV).load_state_dict(sd)
    row["checkpoint"] = {"file": os.path.basename(ckpt), "meta": meta}
    return ckpt, row


def run_mf_cli_phase(data: str) -> dict:
    """mf_training (uni), lf_training (lft at 256, train and test) and
    base_model_mf (128^2, 256^2, 584x565) at full width and depth
    (canonical 31M, bf16, default routes, independent DropBlock in
    training) on the generated tree. Returns each command's launches."""
    check_k3_sizes()
    runs = os.path.join(DRIVE_ROOT, "runs")
    n_train, n_val, n_test = 3 * AUG_TRAIN, 2, 2
    cfg = tunet.canonical_config(**CLI_CFG)
    base = ["-data_path", data, "-num_epochs", "1", "--auto_lr_find", "False", "-lr", "1e-3",
            "--gradient_clip_val", "0.5", "-seed", "0"] + CLI_FLAGS
    # one epoch of n_train steps, n_val validation forwards, then the final
    # metrics' n_test + n_val forwards: K3 3 per forward, twice per step (remat)
    trained = train_want(n_train, n_val + n_test + n_val)
    rows, launches = [], {}

    argv = ["-mode", "train", "-policy", "uni", "-orig_train_size", "3",
            "-num_augmentations", str(AUG_TRAIN), "-save_path", os.path.join(runs, "mf")] + base
    plan = cli_mf.size_plan_for(cli_mf.build_parser().parse_args(argv), n_train)
    sizes = {str(s): int((plan == s).sum()) for s in (-1, 256, 128)}
    if len(plan) != n_train or 0 in sizes.values():
        raise AssertionError(f"uni size plan {plan}")
    mf_ckpt, row = run_trained_cli("mf_training-uni-train", cli_mf.main, argv, trained,
                                   n_val, n_test, (584, 565), cfg)
    row["size_plan_counts"] = sizes
    rows.append(row)
    launches["cli_mf_uni_train"] = row["launches"]

    argv = ["-mode", "train", "-policy", "lft", "-new_size", "256",
            "-save_path", os.path.join(runs, "lf")] + base
    lf_ckpt, row = run_trained_cli("lf_training-lft-train", cli_lf.main, argv, trained,
                                   n_val, n_test, (256, 256), cfg)
    rows.append(row)
    launches["cli_lf_lft_train"] = row["launches"]

    argv = ["-mode", "test", "-policy", "lft", "-new_size", "256", "-model_path", lf_ckpt,
            "-data_path", data, "-save_path", os.path.join(runs, "lf_test"), "-seed", "0"] + CLI_FLAGS
    out, row = run_cli("lf_training-lft-test", cli_lf.main, argv,
                       {"conv3x3_pair": 3 * (n_test + n_val),
                        **epilogue(forwards=n_test + n_val)})
    row["metrics"] = check_cli_tree("lf test", out, n_val, n_test, (256, 256))
    rows.append(row)
    launches["cli_lf_lft_test"] = row["launches"]

    argv = ["-model_path", mf_ckpt, "-data_path", data, "-save_path", os.path.join(runs, "bm"),
            "-height", ",".join(str(h) for h, _ in MF_SIZES),
            "-width", ",".join(str(w) for _, w in MF_SIZES)] + CLI_FLAGS
    bm_forwards = (n_test + n_val) * len(MF_SIZES)
    out, row = run_cli("base_model_mf", cli_base_model_mf.main, argv,
                       {"conv3x3_pair": 3 * bm_forwards, **epilogue(forwards=bm_forwards)})
    if sorted(os.listdir(out)) != sorted(f"{h}x{w}" for h, w in MF_SIZES):
        raise AssertionError(f"base_model_mf sizes {os.listdir(out)}")
    row["metrics"] = {f"{h}x{w}": check_cli_tree(f"base_model_mf {h}x{w}",
                                                  os.path.join(out, f"{h}x{w}"), n_val, n_test,
                                                  (h, w)) for h, w in MF_SIZES}
    rows.append(row)
    launches["cli_base_model_mf"] = row["launches"]
    for row in rows:
        emit({"phase": "mf-cli", "config": "canonical 31M, --precision bf16, default routes "
              "(-conv_impl pair, -mask_impl fused), independent DropBlock b=7 in training",
              "input": [584, 565], "splits": {"train": n_train, "val": n_val, "test": n_test},
              **row})
    return launches


# --- the analysis half: run_matrix end to end and the density report --------

MATRIX_MODELS = ("BM-1", "MF-1", "LF-3")
MATRIX_ITERS, MATRIX_SAVE = 48, 2
# the uncertainty stage's size (LF-3 at -resize 128); every model scores
# its validation images at 584x565 (LF-3's HFT predicts at native size)
MATRIX_SIDE = {"BM-1": (584, 565), "MF-1": (584, 565), "LF-3": (128, 128)}
DENSITY_KINDS = ("std", "cv", "hist", "did")
DENSITY_ROOT = os.path.join(ROOT, "_runs", "chip_smoke_density")


def density_files(models, kinds) -> list:
    """The files of a density report on `models`, each with DB, ROT and
    dependent-run tensors, with masks and targets (all_metrics.csv apart)."""
    groups = ["_".join(g.split(" ")) for g in ev_density.GROUPS]
    files = []
    if "std" in kinds:
        files += ["std_magnitudes_db.csv", "std_magnitudes_rot.csv"]
        files += [os.path.join("All_Models", f"{g}_{run}_STD.png")
                  for g in groups for run in ("DB", "ROT")]
        files += [os.path.join("Single_Models", f"{m}_{run}_STD.png")
                  for m in models for run in ("DB", "ROT")]
    if "cv" in kinds:
        files += [os.path.join("All_Models", f"{g}_{run}_CV.png")
                  for g in groups for run in ("DB", "ROT")]
    if "hist" in kinds:
        files += [os.path.join("Histograms", f"{name}_{m}.png") for m in models
                  for name in ("CV_Histogram", "STD_Dilated_Histogram", "CV_Dilated_Histogram",
                               "STD_InvDilated_Histogram", "CV_InvDilated_Histogram")]
    if "did" in kinds:
        files += [os.path.join("All_Models", f"{m}_DvUD_STD.png") for m in models]
    return sorted(files)


def check_magnitudes(path: str, rows: int) -> list:
    """std_magnitudes_*.csv: `rows` rows of finite min/max/mean/std."""
    with open(path, newline="") as f:
        table = list(csv.reader(f))
    if table[0] != ev_density.MAGNITUDE_COLUMNS or len(table) != rows + 1:
        raise AssertionError(f"{path}: {table[:2]} ({len(table) - 1} rows)")
    values = [[float(v) for v in row[2:6]] for row in table[1:]]
    if not np.isfinite(values).all():
        raise AssertionError(f"{path}: non-finite magnitudes {values}")
    return values


def density_stopwatches() -> dict:
    """Seconds of the density report in the KDE (the card awaited), in
    np.histogram and in PNG writes."""
    return {"kde": Stopwatch([(ev_density, "_kde_curve")]),
            "histogram": Stopwatch([(ev_density, "_histogram")]),
            "png_write": Stopwatch([(ev_density, "write_png")])}


def matrix_want(n_train: int, n_val: int, n_test: int) -> dict:
    """The launches of each command run_matrix runs, from the code's
    arithmetic: a train command's steps, validation and final forwards; a
    test's final forwards; an MC run's ensembles (save, then evaluate) and a
    rotational run's, per validation image."""
    mc = sum(split_chunks(MATRIX_ITERS, MATRIX_SAVE, CHUNK)) * n_val * 2
    rot = rotational_launches("shear", *split_chunks(ROT_ITERS, MATRIX_SAVE, CHUNK))
    return {
        "train": train_want(n_train, n_val + n_test + n_val),
        "test": {"conv3x3_pair": 3 * (n_test + n_val), **epilogue(forwards=n_test + n_val)},
        "dropblock_uncertainty": {"dropblock_fused_apply": TRAIN_SITES * mc,
                                  "conv3x3_pair": 3 * mc, **epilogue(k1_forwards=mc)},
        "rotational_uncertainty": {name: n * n_val for name, n in rot.items()},
        "create_density": {},
    }


def check_matrix_tree(out_root: str, n_val: int, n_test: int) -> dict:
    """Every stage's canonical directory with its files and shapes, and the
    density report's file set. Returns the report's magnitudes."""
    for model in MATRIX_MODELS:
        mdir = os.path.join(out_root, model)
        infos = cli_files(os.path.join(mdir, "model_info"))
        if len(infos) != 1 or not infos[0].startswith("model-epoch="):
            raise AssertionError(f"{model} model_info {infos}")
        check_cli_tree(f"{model} train", os.path.join(mdir, "statistics"), n_val, n_test,
                       (584, 565))
        check_cli_tree(f"{model} test", os.path.join(mdir, "test_statistics"), n_val, n_test,
                       (584, 565))
        side = MATRIX_SIDE[model]
        for run in ("dropblock_uncertainty", "dropblock_uncertainty_dep"):
            out = os.path.join(mdir, run)
            want = ["model_ckpt_symlink.ckpt"] + [
                os.path.join("tensors", f"image_{i}", f"{m}.pt") for i in range(n_val)
                for m in ("mean", "std", "tensors")] + [
                os.path.join("statistics", f) for f in ev_metrics.output_files(n_val, 0, True)]
            if cli_files(out) != sorted(want):
                raise AssertionError(f"{model} {run} tree {cli_files(out)}")
            for i in range(n_val):
                folder = os.path.join(out, "tensors", f"image_{i}")
                check_pt(os.path.join(folder, "mean.pt"), (1, 1, *side))
                if not float(check_pt(os.path.join(folder, "std.pt"), (1, 1, *side)).max()) > 0:
                    raise AssertionError(f"{model} {run} image {i}: std is 0")
        out = os.path.join(mdir, "rotation_uncertainty")
        want = ["model_ckpt_symlink.ckpt"] + [os.path.join(f"image_{i}", f"{m}.pt")
                                              for i in range(n_val)
                                              for m in ("mean", "std", "tensors")]
        if cli_files(out) != sorted(want):
            raise AssertionError(f"{model} rotation_uncertainty tree {cli_files(out)}")
        for i in range(n_val):
            check_pt(os.path.join(out, f"image_{i}", "std.pt"), (1, 1, *side))
    dens = os.path.join(out_root, "density")
    if cli_files(dens) != sorted(density_files(MATRIX_MODELS, DENSITY_KINDS)
                                 + ["all_metrics.csv"]):
        raise AssertionError(f"density report {cli_files(dens)}")
    return {kind: check_magnitudes(os.path.join(dens, f"std_magnitudes_{kind}.csv"),
                                   len(MATRIX_MODELS) * n_val) for kind in ("db", "rot")}


def run_matrix_phase(data: str) -> dict:
    """run_matrix -stage all --with_dependent on BM-1, MF-1 and LF-3 at full
    width (canonical 31M, bf16, default routes) on the generated tree, each
    command's launches asserted; then view_tensors on its out_root, and a
    rerun that skips every stage. Returns the matrix's launches."""
    out_root = os.path.join(DRIVE_ROOT, "matrix")
    n_train, n_val, n_test = 3 * AUG_TRAIN, 2, 2
    argv = ["-stage", "all", "-data_path", data, "-out_root", out_root,
            "-models", ",".join(MATRIX_MODELS), "-num_epochs", "1", "--with_dependent",
            "-orig_train_size", "3", "-num_augmentations", str(AUG_TRAIN),
            "-iter_num", str(MATRIX_ITERS), "-chunk", str(CHUNK), "-save_num", str(MATRIX_SAVE),
            "-warp", "shear", "--auto_lr_find", "False", "-lr", "1e-3",
            "--gradient_clip_val", "0.5", "-seed", "0"] + CLI_FLAGS
    want = matrix_want(n_train, n_val, n_test)
    commands, stage_seconds = [], {}
    run_module, stages = cli_run_matrix._run_module, {}

    def counted(module, args, dry):
        """One stage command: its launches and seconds."""
        before = counts()
        t0 = time.perf_counter()
        run_module(module, args, dry)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in counts().items()}
        kind = args[args.index("-mode") + 1] if "-mode" in args else module
        save_path = os.path.relpath(args[args.index("-save_path") + 1], out_root)
        expect = {**{name: 0 for name in COUNTERS}, **want[kind]}
        if got != expect:
            raise AssertionError(f"matrix {module} {save_path}: launches {got}, "
                                 f"expected {expect}")
        commands.append({"command": module, "kind": kind, "save_path": save_path,
                         "seconds": seconds, "launches": got})

    def timed(name, fn):
        def stage(*a):
            t0 = time.perf_counter()
            fn(*a)
            stage_seconds[name] = time.perf_counter() - t0
        return stage

    for name in ("train", "test", "uncertainty", "density"):
        stages[name] = getattr(cli_run_matrix, f"stage_{name}")
    watches = density_stopwatches()
    reset_counts()
    try:
        cli_run_matrix._run_module = counted
        for name, fn in stages.items():
            setattr(cli_run_matrix, f"stage_{name}", timed(name, fn))
        t0 = time.perf_counter()
        with watches["kde"], watches["histogram"], watches["png_write"]:
            cli_run_matrix.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        cli_run_matrix._run_module = run_module
        for name, fn in stages.items():
            setattr(cli_run_matrix, f"stage_{name}", fn)
    launches = counts()
    assert_wgmma("matrix")
    kinds = [c["kind"] for c in commands]
    expected_kinds = (["train"] * 3 + ["test"] * 3
                      + ["dropblock_uncertainty", "dropblock_uncertainty",
                         "rotational_uncertainty"] * 3 + ["create_density"])
    if kinds != expected_kinds:
        raise AssertionError(f"matrix commands {kinds}")
    magnitudes = check_matrix_tree(out_root, n_val, n_test)
    density_seconds = stage_seconds["density"]
    emit({"phase": "matrix", "command": "run_matrix -stage all --with_dependent",
          "models": list(MATRIX_MODELS), "config": "canonical 31M, --precision bf16, default "
          "routes (-conv_impl pair, -mask_impl fused), -warp shear", "input": [584, 565],
          "splits": {"train": n_train, "val": n_val, "test": n_test}, "seconds": seconds,
          "stage_seconds": stage_seconds, "commands": commands, "launches": launches,
          "density": {"seconds": density_seconds,
                      **{f"{k}_seconds": w.seconds for k, w in watches.items()},
                      **{f"{k}_share": w.seconds / density_seconds for k, w in watches.items()}},
          "magnitudes_rows": {k: len(v) for k, v in magnitudes.items()}})

    # the viewer on the same out_root
    viewer = os.path.join(out_root, "viewer")
    t0 = time.perf_counter()
    cli_view_tensors.main(["-results_root", out_root, "-aug_root", data, "-save_path", viewer,
                           "-models", ",".join(MATRIX_MODELS)])
    view_seconds = time.perf_counter() - t0
    want_files = sorted([f"{m}_image_{i}.png" for m in MATRIX_MODELS for i in range(n_val)]
                        + [f"MSE_Plot_{m}.png" for m in MATRIX_MODELS])
    if cli_files(viewer) != want_files:
        raise AssertionError(f"view_tensors files {cli_files(viewer)}")
    shutil.rmtree(viewer)

    # the rerun skips every stage but the density report, which is redrawn
    reset_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        cli_run_matrix.main(argv)
    rerun_seconds = time.perf_counter() - t0
    skips = [line for line in log.getvalue().splitlines() if "skip" in line]
    stage_count = len(MATRIX_MODELS) * (1 + 1 + 3)
    if len(skips) != stage_count or counts() != {name: 0 for name in COUNTERS}:
        raise AssertionError(f"matrix rerun: {len(skips)} skips of {stage_count}, "
                             f"launches {counts()}")
    emit({"phase": "matrix-rerun", "skipped": len(skips), "seconds": rerun_seconds,
          "view_tensors_seconds": view_seconds, "viewer_files": len(want_files)})
    shutil.rmtree(out_root)
    return {"matrix": launches}


def synthetic_study(rng, models, images: int, hw) -> tuple:
    """Seeded mean/std maps of a study (DB and ROT per model and image) in
    the ranges the ensembles give, a disc FOV as every mask and thresholded
    noise as every target."""
    data = {key: {} for key in ("mean_db", "std_db", "mean_rot", "std_rot")}
    for model in models:
        for kind, scale in (("db", 0.05), ("rot", 0.02)):
            data[f"mean_{kind}"][model] = {i: rng.random((1, 1, *hw), dtype=np.float32)
                                           for i in range(images)}
            data[f"std_{kind}"][model] = {
                i: (rng.exponential(scale, (1, 1, *hw))).astype(np.float32)
                for i in range(images)}
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    disc = ((((yy - hw[0] / 2) / (hw[0] / 2)) ** 2 + ((xx - hw[1] / 2) / (hw[1] / 2)) ** 2)
            < 0.9).astype(np.uint8) * 255
    masks = {i: disc for i in range(images)}
    targets = {i: ((rng.random(hw) > 0.85) * 255).astype(np.uint8) for i in range(images)}
    return data, masks, targets


def run_density_scale_phase() -> None:
    """The density report at a real study's size, from memory: 12 models x 6
    validation images x 584x565 for DB and ROT, kinds std, cv and hist, the
    KDE on the card; then the card's KDE on a 200k-sample subset against
    the plain float64 formula on the CPU (1e-9 of the curve's maximum)."""
    models, images = ev_density.MODELS, 6
    t0 = time.perf_counter()
    data, masks, targets = synthetic_study(np.random.default_rng(8), models, images, (584, 565))
    setup_seconds = time.perf_counter() - t0
    values = sum(v.size for key in ("std_db", "std_rot") for d in data[key].values()
                 for v in d.values())
    shutil.rmtree(DENSITY_ROOT, ignore_errors=True)
    watches = density_stopwatches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with watches["kde"], watches["histogram"], watches["png_write"]:
        ev_density.render_density_report(data, masks, targets, DENSITY_ROOT, models,
                                         ("std", "cv", "hist"), DEV)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    files = cli_files(DENSITY_ROOT)
    if files != density_files(models, ("std", "cv", "hist")):
        raise AssertionError(f"density-scale files {files}")
    rows = {k: len(check_magnitudes(os.path.join(DENSITY_ROOT, f"std_magnitudes_{k}.csv"),
                                    len(models) * images)) for k in ("db", "rot")}
    shutil.rmtree(DENSITY_ROOT)
    if peak > 1 << 30:
        raise AssertionError(f"the KDE's extra device memory {peak} > 1 GiB")

    # the card's KDE against the dense float64 formula on the CPU
    sel = np.concatenate([v.ravel() for v in data["std_db"][models[0]].values()])
    sel = sel[sel > 0.01]
    subset = sel[np.random.default_rng(9).permutation(sel.size)[:200_000]]
    rnge, steps = (0, 0.5), 1000
    t0 = time.perf_counter()
    xs, dens = ev_density._kde_curve(subset, rnge, steps, DEV)
    card_seconds = time.perf_counter() - t0
    h = (rnge[1] - rnge[0]) / steps
    t0 = time.perf_counter()
    x = torch.from_numpy(subset.astype(np.float64))
    grid = torch.from_numpy(np.linspace(*rnge, steps))
    plain = (torch.exp(-0.5 * ((grid[:, None] - x[None, :]) / h) ** 2).sum(1)
             / (subset.size * h * np.sqrt(2 * np.pi))).numpy()
    plain_seconds = time.perf_counter() - t0
    rel = float(np.abs(dens - plain).max() / plain.max())
    if not rel <= 1e-9:
        raise AssertionError(f"KDE on the card vs the float64 formula: {rel} of the maximum")
    emit({"phase": "density-scale", "models": len(models), "images": images,
          "input": [584, 565], "std_values": int(values), "kinds": ["std", "cv", "hist"],
          "seconds": seconds, **{f"{k}_seconds": w.seconds for k, w in watches.items()},
          "other_seconds": seconds - sum(w.seconds for w in watches.values()),
          "kde_peak_extra_bytes": int(peak), "setup_seconds": setup_seconds,
          "magnitudes_rows": rows, "kde_check": {"samples": int(subset.size), "steps": steps,
                                                 "max_rel": rel, "card_seconds": card_seconds,
                                                 "cpu_dense_seconds": plain_seconds}})


# TransUNet R50-ViT-B/16 (models/transunet.py) on the canvas: 45 mask sites (33
# GroupNorm ones: the root and gn1, gn2 of 16 units; 9 BatchNorm ones; 3 bare
# merges), 13 of them rescaled per sample (all but the units' 32), 19 unmasked
# GroupNorms (gn3 of 16 units, gn_proj of 3), 12 attention calls and 4
# upsampling merges a forward
TU_SITES, TU_GN_SITES, TU_BN_SITES, TU_GN_PLAIN_SITES, TU_LAYERS = 45, 33, 9, 19, 12
TU_SAMPLE_SITES, TU_MERGES = 13, 4
# the merges' inputs at chunk 16: x (N, h, w, C) and its skip, or None
TU_MERGE_SHAPES = (((CHUNK, 37, 36, 512), (CHUNK, 74, 72, 512)),
                   ((CHUNK, 74, 72, 256), (CHUNK, 147, 143, 256)),
                   ((CHUNK, 148, 144, 128), (CHUNK, 296, 288, 64)),
                   ((CHUNK, 296, 288, 64), None))


def transunet_want(forwards: int, fused: bool) -> dict:
    """TransUNet's launches in `forwards` eval forwards: K1 at every site
    with GroupNorm's statistics kernels feeding its GroupNorm ones and
    gn_apply's per-sample rescale after the 13 rescaled ones (fused), or
    GroupNorm's epilogue at each GroupNorm site and gn_apply at each
    BatchNorm one (DropBlock off); the unmasked GroupNorms' epilogue; the
    attention on flash; the decoder's merges on the upsampling kernel."""
    gn = TU_GN_PLAIN_SITES + TU_GN_SITES
    want = {"gn_stats": gn * forwards, "gn_stats_finish": gn * forwards,
            "attn:flash": TU_LAYERS * forwards, "upsample_concat": TU_MERGES * forwards,
            "up:kernel": TU_MERGES * forwards}
    if fused:
        want.update(dropblock_fused_apply=TU_SITES * forwards,
                    gn_apply=(TU_GN_PLAIN_SITES + TU_SAMPLE_SITES) * forwards)
    else:
        want["gn_apply"] = (gn + TU_BN_SITES) * forwards
    return want


# TransUNet's sites whose kernels get a `kernels` timing: K1 at the
# odd-size stage-1 sites (gn1, gn2: 147x143x64, GroupNorm coefficients from
# gn_stats) and the last decoder block's 16-channel BatchNorm sites
# (592x576x16); gn_apply at stage 1's gn3 (147x143x256, no activation) and
# the per-sample rescale after those 16-channel sites
TU_TIMED = {"dropblock_fused_apply": ((CHUNK, 147, 143, 64), (CHUNK, H, W, 16)),
            "gn_apply": ((CHUNK, 147, 143, 256), (CHUNK, H, W, 16)),
            "upsample_concat": tuple(x for x, _ in TU_MERGE_SHAPES)}


@contextlib.contextmanager
def held_to_plain(record: dict):
    """While active, each call of K1 and of GroupNorm's forward launches
    (gn_stats, gn_stats_finish, gn_apply) that the models' sites make, and
    of the decoder's upsampling merge, is held at once against its plain
    version on the same card inputs: K1's keep counts equal and its output
    within 2 bf16 ulps (check_k1's gate; both round x*a and then +b to
    bf16); the partial sums and the finishing launch within 1e-5 of the
    plain float32 numbers relative to their largest magnitude (the order of
    the sums differs) and the variance gate exact; gn_apply bit-equal
    (check_gn's gates); the merge bit-equal to the plain route (F.interpolate,
    F.pad, torch.cat), else its worst gap in bf16 ulps and the share of its
    elements off are raised. `record`
    gets, per launch and input shape, the calls and the worst error, and
    the first call's arguments at a TU_TIMED shape."""
    def held(name, fn, plain, compare):
        def call(*a, **k):
            got = fn(*a, **k)
            err = compare(got, plain, a, k)
            shape = tuple(a[0].shape)
            row = record.setdefault(name, {}).setdefault(shape, {"calls": 0, "worst": 0.0})
            row["calls"] += 1
            row["worst"] = max(row["worst"], err)
            if shape in TU_TIMED.get(name, ()) and "args" not in row:
                row["args"] = (a, k)
            return got
        call.launches = 0  # a wrapper counts on its module's name: on this one while patched
        return call

    def k1(got, plain, a, k):
        ref, keep = plain(*a, **k)
        ulps = bf16_ulps(got[0], ref)
        if not torch.equal(got[1], keep) or ulps > 2:
            raise AssertionError(f"K1 {tuple(a[0].shape)}: keep {got[1].tolist()} vs "
                                 f"{keep.tolist()}, {ulps} ulps")
        return ulps

    def stats(got, plain, a, k):
        ref = plain(*a, **k)
        err = max(max_rel(got[j].sum(1), ref[j, :, 0]) for j in range(2))
        if not err <= 1e-5:
            raise AssertionError(f"gn_stats {tuple(a[0].shape)}: {err} from its plain version")
        return err

    def finish(got, plain, a, k):
        rab, rmr = plain(*a, **k)
        err = max(max_rel(got[0], rab), max_rel(got[1][:2], rmr[:2]))
        if not err <= 1e-5 or not torch.equal(got[1][2], rmr[2]):
            raise AssertionError(f"gn_stats_finish {tuple(a[0].shape)}: {err} from its plain "
                                 "version, or the variance gate differs")
        return err

    def apply(got, plain, a, k):
        if not torch.equal(got, plain(*a, **k)):
            raise AssertionError(f"gn_apply {tuple(a[0].shape)}: not bit-equal to its plain "
                                 "version")
        return 0.0

    def merge(got, plain, a, k):
        ref = plain(*a, **k)
        if not torch.equal(got, ref):
            off = float((got != ref).float().mean())
            raise AssertionError(f"upsample_concat {tuple(a[0].shape)}: {bf16_ulps(got, ref)} "
                                 f"bf16 ulps at worst, {off:.3e} of the elements off the plain "
                                 "route")
        return 0.0

    patched = [(tsites, "dropblock_fused_apply", dbk.dropblock_fused_apply_plain, k1),
               (gnk, "gn_stats", gnk.gn_stats_plain, stats),
               (tsites, "gn_stats", gnk.gn_stats_plain, stats),
               (gnk, "gn_stats_finish", gnk.gn_stats_finish_plain, finish),
               (tsites, "gn_stats_finish", gnk.gn_stats_finish_plain, finish),
               (gnk, "gn_apply", gnk.gn_apply_plain, apply),
               (tsites, "gn_apply", gnk.gn_apply_plain, apply),
               (upk, "upsample_concat", upk.upsample_concat_plain, merge)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in patched]
    for mod, name, plain, compare in patched:
        setattr(mod, name, held(name, getattr(mod, name), plain, compare))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            fn.launches += getattr(mod, name).launches
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_sites(where: str):
    """plain_epilogue, BatchNorm's sites and the per-sample rescale off
    gn_apply too (models/sites.py asks `_kernel_input`, refused here), and
    the decoder's merges off the upsampling kernel; on exit, asserts that
    BatchNorm sites took the plain ops (`bn:plain`) and the merges the plain
    route (`up:plain`)."""
    gate, merge_gate = tsites._kernel_input, upk.upsample_concat_supported
    plain, merges = cuda_launches.HOST["bn:plain"], upk.calls["plain"]
    tsites._kernel_input = lambda x: False
    upk.upsample_concat_supported = lambda *a, **k: False
    try:
        with plain_epilogue(where):
            yield
    finally:
        tsites._kernel_input, upk.upsample_concat_supported = gate, merge_gate
    if cuda_launches.HOST["bn:plain"] - plain <= 0:
        raise AssertionError(f"{where}: no BatchNorm site took the plain ops")
    if upk.calls["plain"] - merges != TU_MERGES:
        raise AssertionError(f"{where}: {upk.calls['plain'] - merges} merges on the plain route")


def merge_timing(x, skip) -> dict:
    """The upsampling merge's kernel at a decoder block's own inputs: event ms
    a call (back-to-back launches, so the kernel's device time; no profiler
    here, which late in a whole run recorded no device time), its byte bound
    (x and skip read once, the output written once) and the share of it
    reached; the plain composition's ms (F.interpolate, F.pad, torch.cat)
    and F.interpolate's alone (the library)."""
    n, h, w, c = x.shape
    cs = 0 if skip is None else skip.shape[-1]
    nbytes = (x.numel() + n * 4 * h * w * (c + cs) + (0 if skip is None else skip.numel())
              ) * x.element_size()
    timing = {"shape": list(x.shape), "skip": None if skip is None else list(skip.shape),
              "ms": time_ms(lambda: upk.upsample_concat(x, skip), 20),
              "plain_ms": time_ms(lambda: upk.upsample_concat_plain(x, skip), 5),
              "library_ms": time_ms(lambda: torch.nn.functional.interpolate(
                  x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear", align_corners=True),
                  5),
              "max_err": 0.0, "err_unit": "bit-equal"}
    timing["bound_ms"], timing["bound_by"] = bound_ms(nbytes)
    timing["bound_share"] = timing["bound_ms"] / timing["ms"]
    return timing


def transunet_routes(make, model, xb, fov, site_keys) -> dict:
    """TransUNet's forward of 16 members through the kernel route, and one
    with DropBlock off, with each site's kernels held to their plain
    versions (held_to_plain); the first against the plain routes from the
    same site keys and weights (masks, GroupNorm and BatchNorm, the merges on
    the plain ops) in bf16 and float32, within twice the plain bf16 route's
    distance from float32 (run_slice's gate); each TU_TIMED launch timed at
    its site's own inputs. Returns the timings by launch."""
    record = {}
    with held_to_plain(record):
        kernels = model(xb, drop_prob=P_DROP, site_keys=site_keys) * fov
        # DropBlock off: GroupNorm's epilogue and BatchNorm's gn_apply at every site
        model(xb)
    torch.cuda.synchronize()
    checked = {name: {"x".join(map(str, shape)): {"calls": row["calls"], "worst": row["worst"]}
                      for shape, row in rows.items()} for name, rows in record.items()}
    for name, shapes in TU_TIMED.items():
        missing = [s for s in shapes if "args" not in record.get(name, {}).get(s, {})]
        if missing:
            raise AssertionError(f"transunet: no {name} call at {missing}: {checked}")
    emit({"phase": "transunet-sites", "checked": checked,
          "gates": {"dropblock_fused_apply": "keep exact, <= 2 bf16 ulps",
                    "gn_stats": "1e-5 relative", "gn_stats_finish": "1e-5 relative",
                    "gn_apply": "bit-equal", "upsample_concat": "bit-equal"}})
    outs = {"kernels": kernels}
    for name, dtype in (("plain_bf16", torch.bfloat16), ("plain_f32", torch.float32)):
        m = make(mask_impl="elementwise", dtype=dtype).eval()
        m.load_state_dict(model.state_dict())
        with plain_sites(f"transunet routes {name}"):
            outs[name] = m(xb, drop_prob=P_DROP, site_keys=site_keys) * fov
        del m
    d_kernel = float((outs["kernels"] - outs["plain_bf16"]).abs().max())
    d_bf16 = float((outs["plain_bf16"] - outs["plain_f32"]).abs().max())
    emit({"phase": "transunet-routes", "max_abs_kernel_vs_plain_bf16": d_kernel,
          "max_abs_plain_bf16_vs_f32": d_bf16,
          "max_abs_kernel_vs_f32": float((outs["kernels"] - outs["plain_f32"]).abs().max()),
          "mean_abs_kernel_vs_plain_bf16":
              float((outs["kernels"] - outs["plain_bf16"]).abs().mean())})
    if not d_kernel <= 2.0 * d_bf16:
        raise AssertionError(f"transunet kernel route {d_kernel} vs plain bf16 noise {d_bf16}")
    del outs, kernels
    fns = {"dropblock_fused_apply": (dbk.dropblock_fused_apply, dbk.dropblock_fused_apply_plain),
           "gn_apply": (gnk.gn_apply, gnk.gn_apply_plain)}
    timed = {}
    for name, shapes in TU_TIMED.items():
        if name == "upsample_concat":
            for shape in shapes:
                timing = merge_timing(*record[name][shape]["args"][0])
                emit({"phase": "TU-time", "name": name, **timing})
                timed.setdefault(name, {})["transunet_" + "x".join(map(str, shape))] = timing
            continue
        fn, plain = fns[name]
        for shape in shapes:
            a, k = record[name][shape]["args"]
            x, ab = a[0], a[1]
            nbytes = 2 * x.numel() * x.element_size() + (0 if ab is None else ab.numel() * 4)
            args = inspect.signature(fn).bind(*a, **k)
            args.apply_defaults()
            args = args.arguments
            if name == "gn_apply":
                mask, scale = args["mask"], args["scale"]
                nbytes += (0 if mask is None else mask.numel()) + (
                    0 if scale is None else scale.numel() * 4)
            timing = {"shape": list(shape), "act": args["act"],
                      "ms": time_ms(lambda: fn(*a, **k), 10),
                      "plain_ms": time_ms(lambda: plain(*a, **k), 3, 1),
                      "max_err": record[name][shape]["worst"],
                      "err_unit": "bf16 ulps" if name == "dropblock_fused_apply" else "bit-equal"}
            timing["bound_ms"], timing["bound_by"] = bound_ms(nbytes)
            emit({"phase": "TU-time", "name": name, **timing})
            timed.setdefault(name, {})["transunet_" + "x".join(map(str, shape))] = timing
    return timed


def run_transunet_phase() -> dict:
    """TransUNet at its published widths, bf16, on the 584x565 frame (canvas
    592x576): one eager forward of 16 members with DropBlock on (K1) and its
    CUDA graph replayed, with their launches and attention routes asserted
    (no attn:other, gn:plain or bn:plain) and the replay bit-equal to the
    eager forward; one forward with DropBlock off; the forward's kernels
    held to their plain versions and the plain routes (transunet_routes);
    then the engines
    (MCDropBlockEngine 48 members, RotationalEngine 32) and three trainer
    steps (remat, the mask producer, train-mode BatchNorm through the step
    program) at the same size. Prints each forward's ms, members/s, peaks.
    Returns the launches and transunet_routes' timings."""
    from unet_research_tpu_torch.models import DropBlockConfig, TransUNetConfig, build_model

    def make(**kw):
        db = DropBlockConfig(kind="dependent", block_size=BLOCK,
                             mask_impl=kw.pop("mask_impl", "fused"),
                             use_scheduler=kw.pop("use_scheduler", False), drop_prob=P_DROP,
                             max_drop_prob=P_DROP, nr_steps=8)
        cfg = TransUNetConfig(**{"dtype": torch.bfloat16, "dropblock": db, **kw})
        return build_model(cfg, device=DEV, generator=torch.Generator().manual_seed(0))

    out = {"phase": "transunet"}
    t0 = time.perf_counter()
    model = make().eval()
    out["build_seconds"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    im, gt, fov = (torch.from_numpy(a).to(DEV) for a in synthetic_image())
    xb = im.expand(CHUNK, -1, -1, -1).contiguous()
    site_keys = tunet.draw_site_keys(TU_SITES, torch.Generator().manual_seed(4)).to(DEV)
    total = collections.Counter()

    def forward(drop: bool):
        return model(xb, drop_prob=P_DROP if drop else None,
                     site_keys=site_keys if drop else None)

    def since(before: dict, forwards: int, fused: bool, where: str) -> dict:
        got = cuda_launches.since(before)
        total.update(got)
        want = transunet_want(forwards, fused)
        if {k: got.get(k, 0) for k in want} != want or any(
                got.get(k, 0) for k in ("attn:other", "gn:plain", "bn:plain", "dropblock_mask",
                                        "up:plain")):
            raise AssertionError(f"{where}: launches {got}, want {want}")
        return got

    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = cuda_launches.snapshot()
        t0 = time.perf_counter()
        eager = forward(True)
        torch.cuda.synchronize()
        out["first_eager_seconds"] = time.perf_counter() - t0
        out["eager_launches"] = since(before, 1, True, "transunet eager")
        out["eager_ms"] = time_ms(lambda: forward(True), 3)
        before = cuda_launches.snapshot()
        result = torch.empty_like(eager)
        graph, replay_counts, out["capture_seconds"] = cuda_launches.capture(
            lambda: result.copy_(forward(True)))
        graph.replay()
        cuda_launches.credit(replay_counts)
        torch.cuda.synchronize()
        since(before, 1, True, "transunet replay")
        if not torch.equal(result, eager):
            raise AssertionError("transunet: the replayed forward differs from the eager one "
                                 f"by {float((result - eager).abs().max())}")
        ms = time_ms(graph.replay, 10)
        out.update(replay_ms=ms, members_per_s=CHUNK / ms * 1e3,
                   model_tflops=4.52e11 * CHUNK / ms * 1e-9,
                   forward_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del graph
        before = cuda_launches.snapshot()
        plain = forward(False)
        torch.cuda.synchronize()
        out["drop_off_launches"] = since(before, 1, False, "transunet DropBlock off")
        out["drop_off_ms"] = time_ms(lambda: forward(False), 3)
        out["mean_abs_drop_effect"] = float((eager.float() - plain.float()).abs().mean())
        del eager, plain, result
        timed = transunet_routes(make, model, xb, fov, site_keys)

        before = cuda_launches.snapshot()
        mc = MCDropBlockEngine(model, num_iterations=48, return_num=0, chunk=CHUNK, device=DEV)
        t0 = time.perf_counter()
        mean, std = mc.predict(im, gt, fov, P_DROP, generator=torch.Generator().manual_seed(5))[:2]
        torch.cuda.synchronize()
        out["mc_48_seconds_first"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mean, std = mc.predict(im, gt, fov, P_DROP, generator=torch.Generator().manual_seed(6))[:2]
        torch.cuda.synchronize()
        out["mc_48_seconds"] = time.perf_counter() - t0
        check_outputs(mean, std, torch.zeros((0, 1, 584, 565, 1)), 0)
        rot = RotationalEngine(model, num_iterations=32, return_num=0, chunk=CHUNK, device=DEV)
        mean, std = rot.predict(im, gt, fov)[:2]
        torch.cuda.synchronize()
        check_outputs(mean, std, torch.zeros((0, 1, 584, 565, 1)), 0)
        got = cuda_launches.since(before)
        total.update(got)
        if got.get("attn:other", 0) or not got.get("attn:flash", 0) or got.get("up:plain", 0):
            raise AssertionError(f"transunet engines: launches {got}")
        out["engine_launches"] = got
        out["engine_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del mc, rot

    del model
    torch.cuda.empty_cache()
    model = make(remat=True, use_scheduler=True)
    trainer = Trainer(model, POLICIES["none"], TrainerConfig(lr=1e-3, auto_lr_find=False,
                                                             verbose=False, seed=3), device=DEV)
    state = trainer.create_state(None, 1e-3)
    data = tuple(torch.from_numpy((np.clip(a, 0, 1) * 255).astype(np.uint8)).to(DEV)
                 .expand(4, -1, -1, -1).contiguous() for a in synthetic_image())
    start = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    before = cuda_launches.snapshot()
    t0 = time.perf_counter()
    losses = trainer.train_epoch_scan(state, data, np.arange(4), 1e-3)
    out["train_seconds"] = time.perf_counter() - t0
    got = cuda_launches.since(before)
    total.update(got)
    moved = max(float((p.detach() - q).abs().max()) for p, q in zip(model.parameters(), start))
    if not (np.isfinite(losses).all() and moved > 0 and got.get("dropblock_mask", 0)
            and not got.get("attn:other", 0) and not got.get("gn:plain", 0)
            and not got.get("up:plain", 0) and got.get("up:kernel", 0)):
        raise AssertionError(f"transunet train: losses {losses}, moved {moved}, launches {got}")
    out.update(train_losses=[float(v) for v in losses], train_launches=got,
               train_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               train_step_ms=time_ms(lambda: trainer.train_epoch_scan(state, data,
                                                                      np.arange(4), 1e-3),
                                     2, warmup=0) / 4)
    emit(out)
    del trainer, state, model
    torch.cuda.empty_cache()
    return {k: total.get(k, 0) for k in COUNTERS}, timed


def main() -> None:
    # float32 references run in full float32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    header()
    emit({"phase": "env", "imports": optional_libraries()})
    build_kernels()
    if sys.argv[1:] == ["transunet"]:  # that phase alone
        run_transunet_phase()
        emit({"ok": True, "phase": "transunet"})
        return
    if sys.argv[1:] == ["k1-merge"]:  # that check alone
        check_k1_merge()
        emit({"ok": True, "phase": "k1-merge"})
        return
    rows = [check_k1(), check_k2(), check_k3(), check_k4(), check_k4_table(),
            *check_k3_backward()]
    gn_rows = check_gn()
    merge_row = check_k1_merge()
    check_k3_valid()
    check_offsets()
    state = base_state()
    launches = run_slice(state)
    mc_program = run_mc_program(state, launches["bf16_noise"])
    rotational = run_rotational(state)
    rotational_program = run_rotational_program(state, rotational["bf16_noise"])
    mc_full, mc_full_merges = run_mc_full_phase(state, launches["bf16_noise"])
    run_train_routes(state)
    train, steps = run_train_slice(state)
    run_train_scan(state)
    step_program = run_train_step_program(state)
    eval_program, eval_refs = run_eval_program(state)
    dp = run_dp_phase(launches)
    dp.update(run_dp_nccl(state, eval_refs, launches["bf16_noise"]))
    del eval_refs
    cli = run_cli_phase()
    data = run_drive_augment_phase()
    cli.update(run_mf_cli_phase(data))
    cli.update(run_matrix_phase(data))
    epoch_time = run_epoch_time_phase(data)
    shutil.rmtree(DRIVE_ROOT)
    run_density_scale_phase()
    transunet, transunet_timed = run_transunet_phase()
    check_failed_capture(state)
    # each path's counts, read right after it ran; `launches` is the path
    # that runs the kernel by default (K1 and K3: mc-full's 1000-member
    # predicts, K2: training)
    paths = {"mc_full": mc_full, "mc": launches["main"],
             "mc_kernel_variant": launches["kernel_variant"], "mc_program": mc_program,
             "rotational_shear": rotational["shear"],
             "rotational_program_shear": rotational_program["shear"],
             "rotational_program_gather": rotational_program["gather"], "train": train,
             **step_program, **eval_program, **dp,
             **cli, **epoch_time, "transunet": transunet}
    for row, name, main_path in zip(rows, ("dropblock_fused_apply", "dropblock_mask",
                                           "conv3x3_pair", "rotate_fan", "rotate_fan_table",
                                           "conv3x3_pair_dx", "conv3x3_pair_fold"),
                                    ("mc_full", "train", "mc_full", "rotational_shear",
                                     "rotational_shear", "train", "train")):
        row["launches"] = paths[main_path][name]
        row["launches_by_path"] = {p: c[name] for p, c in paths.items() if c[name]}
    rows[5]["launches_per_train_step"] = train["conv3x3_pair_dx"] / steps
    for row in gn_rows:
        row["launches"] = train[row["name"]]
        row["launches_by_path"] = {p: c[row["name"]] for p, c in paths.items() if c[row["name"]]}
    rows += gn_rows
    merge_row["launches"] = mc_full_merges["mc_full"]
    merge_row["launches_by_path"] = {p: c for p, c in mc_full_merges.items() if c}
    rows.append(merge_row)
    rows.append({"name": "upsample_concat", "route": "cuda",
                 "source": "unet_research_tpu_torch/ops/cuda/csrc/upsample.cu",
                 "replaces": "none: TransUNet exists only in the port",
                 "launches": transunet["upsample_concat"],
                 "launches_by_path": {p: c.get("upsample_concat", 0) for p, c in paths.items()
                                      if c.get("upsample_concat", 0)}})
    for row in rows:  # the launches timed at TransUNet's own sites
        row.update(transunet_timed.get(row["name"], {}))
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
