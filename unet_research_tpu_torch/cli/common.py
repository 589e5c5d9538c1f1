"""Shared CLI plumbing (twin of unet_research_tpu/cli/common.py): the
reference's public flag surface and the model/data assembly.

Every reference entry point takes single-dash long options plus the whole
PL Trainer namespace (Trainer.add_argparse_args,
base_model_tests/training.py:239-267). The documented flags are kept as
they are; the Trainer flags that map onto this stack are honoured
(--gradient_clip_val, --check_val_every_n_epoch, --max_epochs, --precision
16/bf16 -> torch.bfloat16, --gpus/--devices N -> the size of the
data-parallel mesh) and every other one is accepted and ignored with a
notice.

`--devices N` above 1 (training, mf_training, lf_training and
dropblock_uncertainty, the commands whose JAX twins take a mesh): outside a
process group the command spawns N ranks (parallel/launch.py; rank r on
cuda:r, or on the CPU over gloo under `-device cpu`), each of which runs
the command again inside the group on its rows of every batch or chunk;
rank 0 alone prints and writes, so the output tree is the one-process
run's. The other commands run on one device and refuse N > 1.

Two differences from the JAX CLIs: `-device cuda|cpu` (default cuda; the
card, unless the CPU is asked for), and the kernel routes as defaults:
`-conv_impl pair` (the hand-written 3x3 conv K3; `xla` selects cuDNN) and
`-mask_impl fused` (K1 in the ensembles; training takes the mask producer
K2). The JAX CLIs ship their TPU kernels off, because on the TPU they lost
end to end.
"""

from __future__ import annotations

import argparse
import os
import sys
from os.path import join
from typing import Callable, Optional

import torch
import torch.distributed as dist

from unet_research_tpu_torch.data.dataset import load_split
from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.evaluation.metrics import final_test_metrics
from unet_research_tpu_torch.models import (
    ARCHS,
    DropBlockConfig,
    TransUNetConfig,
    build_model,
    canonical_config,
)
from unet_research_tpu_torch.parallel import launch
from unet_research_tpu_torch.parallel.mesh import make_mesh
from unet_research_tpu_torch.train import Trainer, TrainerConfig
from unet_research_tpu_torch.train.checkpoint import load_checkpoint
from unet_research_tpu_torch.train.policies import ResizePolicy
from unet_research_tpu_torch.utils.convert import load_model_checkpoint
from unet_research_tpu_torch.utils.general import create_dir, seed_everything

# -conv_impl values -> the port's UNetConfig.conv_impl
CONV_IMPLS = {"pair": "pair", "xla": "torch"}


def add_common_train_args(parser: argparse.ArgumentParser) -> None:
    """The shared reference flags (training.py:243-256)."""
    parser.add_argument("-mode", dest="mode", type=str, required=True, help="Mode: train or test")
    parser.add_argument("-model_path", dest="model_path", type=str, help="checkpoint path for -mode test")
    parser.add_argument("-data_path", dest="data_path", required=True, help="augmented data root with train/val/test splits")
    parser.add_argument("-save_path", dest="save_path", required=True, help="output folder (suffix-retried if it exists)")
    parser.add_argument("-num_epochs", dest="num_epochs", type=int, default=50)
    parser.add_argument("-train_batch", dest="train_batch", type=int, default=1)
    parser.add_argument("-val_batch", dest="val_batch", type=int, default=1)
    parser.add_argument("-lr", dest="lr", type=float, default=1e-3)
    parser.add_argument("-momentum", dest="momentum", type=float, default=0.99)
    parser.add_argument("-block_size", dest="block_size", type=int, default=7)
    parser.add_argument("-max_drop_prob", dest="max_drop_prob", type=float, default=0.15)
    parser.add_argument("-dropblock_steps", dest="dropblock_steps", type=int, default=1500)
    parser.add_argument("-seed", dest="seed", type=int, default=-1)


def add_arch_args(parser: argparse.ArgumentParser) -> None:
    """Architecture and route flags beyond the reference surface (defaults:
    the canonical 31M configuration, which the reference hardcodes,
    training.py:171-192), and the device. -arch transunet_r50_b16 builds
    TransUNet R50-ViT-B/16 at its published widths instead; -filters and
    -group_norm_groups then set its ResNet's width and GroupNorm groups
    (published 64 and 32), -model_depth, -norm, -activation and -conv_impl
    are the U-Net's alone."""
    parser.add_argument("-arch", dest="arch", choices=ARCHS, default="unet",
                        help="the model: unet (the study's U-Net) | transunet_r50_b16")
    parser.add_argument("-filters", dest="filters", type=int, default=64)
    parser.add_argument("-model_depth", dest="model_depth", type=int, default=4)
    parser.add_argument("-group_norm_groups", dest="group_norm_groups", type=int, default=32)
    parser.add_argument(
        "-remat", dest="remat", type=str, default="true",
        help="recompute block activations in the backward when training (the "
        "reference always checkpoints via fairscale; 'false' trades memory for speed)")
    parser.add_argument(
        "-norm", dest="norm", type=str, default="group",
        help="normalization: group | batch | none (utils_unet.py:136-153)")
    parser.add_argument(
        "-activation", dest="activation", type=str, default="relu",
        help="activation: relu | leaky_relu | elu | gelu | silu | tanh | sigmoid | "
        "none (utils_unet.py:155)")
    parser.add_argument(
        "-conv_impl", dest="conv_impl", choices=tuple(CONV_IMPLS), default="pair",
        help="3x3 convs: pair (the hand-written kernel at the eligible sites) or "
        "xla (cuDNN everywhere)")
    parser.add_argument(
        "-mask_impl", dest="mask_impl", choices=("fused", "kernel", "elementwise"),
        default="fused",
        help="DropBlock masks: fused (the fused kernel) | kernel (the mask "
        "producer) | elementwise (plain PyTorch)")
    parser.add_argument("-device", dest="device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run: the card (default) or the CPU")


def add_trainer_args(parser: argparse.ArgumentParser) -> None:
    """The honoured subset of PL Trainer flags."""
    parser.add_argument("--gradient_clip_val", type=float, default=None)
    parser.add_argument("--check_val_every_n_epoch", type=int, default=1)
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--gpus", "--devices", dest="devices", type=int, default=1,
                        help="data-parallel ranks (one per card, or CPU ranks under -device "
                        "cpu); 1 for the commands that run on one device")
    parser.add_argument("--precision", type=str, default="32",
                        help="'bf16'/'16' selects bfloat16 compute")
    parser.add_argument("--auto_lr_find", type=str, default="True")
    parser.add_argument("--profiler", type=str, default=None)
    parser.add_argument("--detect_anomaly", action="store_true")


def parse_with_passthrough(parser: argparse.ArgumentParser, argv=None,
                           split: Optional[str] = None):
    """parse_known_args, with a notice for the ignored Trainer flags (the
    reference accepts the whole Trainer namespace). Resolves -device (raises
    when CUDA is asked for and absent) and checks --devices, before anything
    is read or written.

    split: the flag whose value the ranks of `--devices N` divide
    (train_batch, chunk); None for a command that runs on one device, which
    refuses N > 1. Inside a process group (a spawned rank) args.mesh is the
    mesh of N ranks and args.device this rank's device; else None."""
    args, unknown = parser.parse_known_args(argv)
    if unknown and not dist.is_initialized():
        print(f"[unet_research_tpu_torch] accepted-and-ignored Trainer flags: {unknown}")
    n = getattr(args, "devices", 1)
    if n > 1 and split is None:
        raise NotImplementedError(f"--devices {n}: this command runs on one device "
                                  "(its JAX twin takes no mesh); run it with --devices 1")
    args.device = resolve_device(args.device)
    args.mesh = None
    if n > 1:
        if args.device.type == "cuda" and n > torch.cuda.device_count():
            raise ValueError(f"--devices {n}: this host has {torch.cuda.device_count()} cards")
        if getattr(args, split) % n:
            raise ValueError(f"-{split} {getattr(args, split)} does not divide over "
                             f"--devices {n}")
        if dist.is_initialized():
            args.mesh = make_mesh(data=n, device=args.device)
            args.device = args.mesh.device
    return args


def rank0(args) -> bool:
    """Whether this process prints and writes: one-process runs and rank 0."""
    return args.mesh is None or args.mesh.rank == 0


def run_cli(main: Callable, build_parser: Callable, run: Callable, argv=None,
            split: Optional[str] = None):
    """A command's main: parse argv and return run(args). Under `--devices N`
    outside a process group, spawn N ranks that each call main(argv) and
    return rank 0's result (the other ranks' runs return None)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_with_passthrough(build_parser(), argv, split)
    n = getattr(args, "devices", 1)
    if n > 1 and args.mesh is None:
        if args.device.type == "cpu":
            return launch.spawn(main, (argv,), ["cpu"] * n, backend="gloo")
        return launch.spawn(main, (argv,), [f"cuda:{r}" for r in range(n)])
    return run(args)


def compute_dtype(args) -> torch.dtype:
    prec = str(getattr(args, "precision", "32")).lower()
    return torch.bfloat16 if prec in ("16", "bf16", "bfloat16") else torch.float32


def build_network(args, dropblock_kind: Optional[str], use_scheduler: bool,
                  drop_prob: Optional[float] = None, remat: bool = False):
    """The model of -arch on args.device: the canonical UNet every reference
    entry point builds (training.py:171-192), or TransUNet R50-ViT-B/16;
    its weights come from a checkpoint or the trainer's seeded
    initialisation."""
    db = DropBlockConfig(
        kind=dropblock_kind,
        block_size=args.block_size,
        drop_prob=drop_prob if drop_prob is not None else args.max_drop_prob,
        use_scheduler=use_scheduler,
        start_drop_prob=0.0,
        max_drop_prob=args.max_drop_prob,
        nr_steps=args.dropblock_steps,
        mask_impl=args.mask_impl,
    )
    if getattr(args, "arch", "unet") == "transunet_r50_b16":
        cfg = TransUNetConfig(dropblock=db, remat=remat, dtype=compute_dtype(args),
                              width=args.filters, gn_groups=args.group_norm_groups)
        return build_model(cfg, device=args.device)
    cfg = canonical_config(
        dropblock=db,
        remat=remat,
        dtype=compute_dtype(args),
        filters=args.filters,
        model_depth=args.model_depth,
        group_norm_groups=args.group_norm_groups,
        norm=None if args.norm in ("none", "None") else args.norm,
        activation=args.activation,
        conv_impl=CONV_IMPLS[args.conv_impl],
    )
    return build_model(cfg, device=args.device)


def load_datasets(data_path: str, with_train: bool = True):
    train = load_split(join(data_path, "train")) if with_train else None
    val = load_split(join(data_path, "val"))
    test = load_split(join(data_path, "test"), with_targets=False)
    return train, val, test


def make_trainer(args, policy: ResizePolicy, dropblock_kind: str, remat: bool = True) -> Trainer:
    """The trainer of the training CLIs: the model of build_network with the
    DropBlock scheduler, under `policy`, with the honoured Trainer flags."""
    remat = remat and str(args.remat).lower() != "false"
    model = build_network(args, dropblock_kind=dropblock_kind, use_scheduler=True, remat=remat)
    tcfg = TrainerConfig(
        max_epochs=args.max_epochs or args.num_epochs,
        lr=args.lr,
        momentum=args.momentum,
        clip_norm=args.gradient_clip_val,
        auto_lr_find=str(args.auto_lr_find).lower() != "false",
        check_val_every_n_epoch=args.check_val_every_n_epoch,
        train_batch=args.train_batch,
        val_batch=args.val_batch,
        seed=args.seed,
        profiler=args.profiler,
        detect_anomaly=args.detect_anomaly,
    )
    return Trainer(model, policy, tcfg, mesh=args.mesh, device=args.device)


def make_output_dir(args) -> Optional[str]:
    """Seed the run (unless -seed is -1) and create -save_path,
    suffix-retried, as every CLI of the reference starts. None on a rank
    other than 0, which writes nothing."""
    if args.seed != -1:
        seed_everything(args.seed)
    if not rank0(args):
        return None
    dest = create_dir(args.save_path)
    if dest is None:
        raise SystemExit(1)
    return dest


def fit_and_score(trainer: Trainer, dest: Optional[str], train_ds, val_ds, test_ds,
                  size_plan=None, resume_from: Optional[str] = None) -> Optional[str]:
    """-mode train after the data is read: fit into dest/model_info, reload
    the best checkpoint and write the final metrics into dest/statistics
    (training.py:227-231). dest None: a rank other than 0, which takes part
    in the fit only."""
    model_info = None if dest is None else join(dest, "model_info")
    if dest is not None:
        os.makedirs(model_info)
    _, history, keeper = trainer.fit(train_ds, val_ds, model_info, size_plan=size_plan,
                                     resume_from=resume_from)
    if dest is None:
        return None
    params, _, _ = load_checkpoint(keeper.best_path)
    statistics = join(dest, "statistics")
    os.makedirs(statistics)
    final_test_metrics(lambda ds: trainer.predict(params, ds), val_ds, test_ds, statistics, history)
    return dest


def score_checkpoint(args, trainer_for) -> Optional[str]:
    """-mode test: the final metrics of -model_path (a JAX msgpack
    checkpoint, a reference PL .ckpt or the port's own) on the val and test
    splits, under the trainer that trainer_for(args, remat=False) builds.
    Under a mesh rank 0 predicts alone."""
    if not rank0(args):
        return None
    stats = make_output_dir(args)
    _, val_ds, test_ds = load_datasets(args.data_path, with_train=False)
    trainer = trainer_for(args, remat=False)
    params, _ = load_model_checkpoint(args.model_path, trainer.model.cfg)
    final_test_metrics(lambda ds: trainer.predict(params, ds), val_ds, test_ds, stats)
    return stats


def run_mode(args, training, testing) -> str:
    """-mode train or test of a training CLI."""
    if args.mode == "train":
        return training(args)
    if args.mode == "test":
        return testing(args)
    raise SystemExit(f"unknown mode {args.mode}")
