"""Shared CLI plumbing (twin of unet_research_tpu/cli/common.py): the
reference's public flag surface and the model/data assembly.

Every reference entry point takes single-dash long options plus the whole
PL Trainer namespace (Trainer.add_argparse_args,
base_model_tests/training.py:239-267). The documented flags are kept as
they are; the Trainer flags that map onto this stack are honoured
(--gradient_clip_val, --check_val_every_n_epoch, --max_epochs, --precision
16/bf16 -> torch.bfloat16) and every other one is accepted and ignored
with a notice. `--gpus/--devices` above 1 raises: data-parallel training is
not ported yet (ROADMAP item 8).

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
from os.path import join
from typing import Optional

import torch

from unet_research_tpu_torch.data.dataset import load_split
from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.evaluation.metrics import final_test_metrics
from unet_research_tpu_torch.models.unet import DropBlockConfig, UNet, canonical_config
from unet_research_tpu_torch.train import Trainer, TrainerConfig
from unet_research_tpu_torch.train.checkpoint import load_checkpoint
from unet_research_tpu_torch.train.policies import ResizePolicy
from unet_research_tpu_torch.utils.convert import load_model_checkpoint
from unet_research_tpu_torch.utils.general import create_dir, seed_everything

# -conv_impl values -> the port's UNetConfig.conv_impl
_CONV_IMPLS = {"pair": "pair", "xla": "torch"}


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
    training.py:171-192), and the device."""
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
        "-conv_impl", dest="conv_impl", choices=tuple(_CONV_IMPLS), default="pair",
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
                        help="device count; only 1 (data-parallel training is ROADMAP item 8)")
    parser.add_argument("--precision", type=str, default="32",
                        help="'bf16'/'16' selects bfloat16 compute")
    parser.add_argument("--auto_lr_find", type=str, default="True")
    parser.add_argument("--profiler", type=str, default=None)
    parser.add_argument("--detect_anomaly", action="store_true")


def parse_with_passthrough(parser: argparse.ArgumentParser, argv=None):
    """parse_known_args, with a notice for the ignored Trainer flags (the
    reference accepts the whole Trainer namespace). Resolves -device (raises
    when CUDA is asked for and absent) and refuses --devices > 1, before
    anything is read or written."""
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        print(f"[unet_research_tpu_torch] accepted-and-ignored Trainer flags: {unknown}")
    if getattr(args, "devices", 1) > 1:
        raise NotImplementedError(
            f"--devices {args.devices}: data-parallel training across cards is not "
            "ported yet (ROADMAP item 8); run with one device")
    args.device = resolve_device(args.device)
    return args


def compute_dtype(args) -> torch.dtype:
    prec = str(getattr(args, "precision", "32")).lower()
    return torch.bfloat16 if prec in ("16", "bf16", "bfloat16") else torch.float32


def build_unet(args, dropblock_kind: Optional[str], use_scheduler: bool,
               drop_prob: Optional[float] = None, remat: bool = False) -> UNet:
    """The canonical UNet every reference entry point builds
    (training.py:171-192), on args.device; its weights come from a
    checkpoint or the trainer's seeded initialisation."""
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
    cfg = canonical_config(
        dropblock=db,
        remat=remat,
        dtype=compute_dtype(args),
        filters=args.filters,
        model_depth=args.model_depth,
        group_norm_groups=args.group_norm_groups,
        norm=None if args.norm in ("none", "None") else args.norm,
        activation=args.activation,
        conv_impl=_CONV_IMPLS[args.conv_impl],
    )
    return UNet(cfg, device=args.device)


def load_datasets(data_path: str, with_train: bool = True):
    train = load_split(join(data_path, "train")) if with_train else None
    val = load_split(join(data_path, "val"))
    test = load_split(join(data_path, "test"), with_targets=False)
    return train, val, test


def make_trainer(args, policy: ResizePolicy, dropblock_kind: str, remat: bool = True) -> Trainer:
    """The trainer of the training CLIs: the model of build_unet with the
    DropBlock scheduler, under `policy`, with the honoured Trainer flags."""
    remat = remat and str(args.remat).lower() != "false"
    model = build_unet(args, dropblock_kind=dropblock_kind, use_scheduler=True, remat=remat)
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
    return Trainer(model, policy, tcfg, device=args.device)


def make_output_dir(args) -> str:
    """Seed the run (unless -seed is -1) and create -save_path,
    suffix-retried, as every CLI of the reference starts."""
    if args.seed != -1:
        seed_everything(args.seed)
    dest = create_dir(args.save_path)
    if dest is None:
        raise SystemExit(1)
    return dest


def fit_and_score(trainer: Trainer, dest: str, train_ds, val_ds, test_ds, size_plan=None,
                  resume_from: Optional[str] = None) -> str:
    """-mode train after the data is read: fit into dest/model_info, reload
    the best checkpoint and write the final metrics into dest/statistics
    (training.py:227-231)."""
    model_info = join(dest, "model_info")
    os.makedirs(model_info)
    _, history, keeper = trainer.fit(train_ds, val_ds, model_info, size_plan=size_plan,
                                     resume_from=resume_from)
    params, _, _ = load_checkpoint(keeper.best_path)
    statistics = join(dest, "statistics")
    os.makedirs(statistics)
    final_test_metrics(lambda ds: trainer.predict(params, ds), val_ds, test_ds, statistics, history)
    return dest


def score_checkpoint(args, trainer_for) -> str:
    """-mode test: the final metrics of -model_path (a JAX msgpack
    checkpoint, a reference PL .ckpt or the port's own) on the val and test
    splits, under the trainer that trainer_for(args, remat=False) builds."""
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
