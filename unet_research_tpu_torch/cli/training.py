"""Base-model training/testing CLI (twin of unet_research_tpu/cli/training.py).

Covers reference base_model_tests/training.py (native-resolution training)
and training-RED.py (its -train_ratio sequential-subset variant,
training-RED.py:163-167). Flags, checkpoint naming and the statistics
output tree match the reference; see cli/common.py for the Trainer flags.

Usage:
  python -m unet_research_tpu_torch.cli.training -mode train -data_path AUG -save_path OUT [-train_ratio .3]
  python -m unet_research_tpu_torch.cli.training -mode test -model_path CKPT -data_path AUG -save_path OUT

-model_path may be a JAX msgpack checkpoint, a reference PL .ckpt or a
checkpoint of this port; -resume_from only the port's own, as a JAX
checkpoint's optimizer state is not carried over.
"""

from __future__ import annotations

import argparse
import math
import os
from os.path import join

from unet_research_tpu_torch.cli import common
from unet_research_tpu_torch.evaluation.metrics import final_test_metrics
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig
from unet_research_tpu_torch.train.checkpoint import load_checkpoint
from unet_research_tpu_torch.utils.convert import checkpoint_format, load_model_checkpoint
from unet_research_tpu_torch.utils.general import create_dir, seed_everything


def make_trainer(args, policy_name: str = "none", remat: bool = True) -> Trainer:
    remat = remat and str(args.remat).lower() != "false"
    model = common.build_unet(args, dropblock_kind="dependent", use_scheduler=True, remat=remat)
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
    return Trainer(model, POLICIES[policy_name], tcfg, device=args.device)


def training(args) -> str:
    if args.resume_from is not None and checkpoint_format(args.resume_from) != "torch":
        raise ValueError(f"-resume_from {args.resume_from}: a JAX checkpoint's optimizer "
                         "state is not carried over; resume from a checkpoint of this port")
    if args.seed != -1:
        seed_everything(args.seed)
    dest = create_dir(args.save_path)
    if dest is None:
        raise SystemExit(1)

    train_ds, val_ds, test_ds = common.load_datasets(args.data_path)
    if args.train_ratio != 1.0:
        train_ds = train_ds.subset(math.ceil(args.train_ratio * len(train_ds)))

    trainer = make_trainer(args, "red" if args.train_ratio != 1.0 else "none")
    model_info = join(dest, "model_info")
    os.makedirs(model_info)
    _, history, keeper = trainer.fit(train_ds, val_ds, model_info, resume_from=args.resume_from)

    # reload the best checkpoint for the final metrics (training.py:227-231)
    params, _, _ = load_checkpoint(keeper.best_path)
    statistics = join(dest, "statistics")
    os.makedirs(statistics)
    final_test_metrics(lambda ds: trainer.predict(params, ds), val_ds, test_ds, statistics, history)
    return dest


def testing(args) -> str:
    if args.seed != -1:
        seed_everything(args.seed)
    stats = create_dir(args.save_path)
    if stats is None:
        raise SystemExit(1)
    _, val_ds, test_ds = common.load_datasets(args.data_path, with_train=False)
    trainer = make_trainer(args, remat=False)
    params, _ = load_model_checkpoint(args.model_path, trainer.model.cfg)
    final_test_metrics(lambda ds: trainer.predict(params, ds), val_ds, test_ds, stats)
    return stats


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_train_args(parser)
    parser.add_argument(
        "-train_ratio", dest="train_ratio", type=float, default=1.0,
        help="RED variant: sequentially truncate the train set to this ratio")
    parser.add_argument(
        "-resume_from", dest="resume_from", type=str, default=None,
        help="a checkpoint of this port to resume training from (weights + optimizer state)")
    common.add_arch_args(parser)
    common.add_trainer_args(parser)
    return parser


def main(argv=None):
    args = common.parse_with_passthrough(build_parser(), argv)
    if args.mode == "train":
        return training(args)
    if args.mode == "test":
        return testing(args)
    raise SystemExit(f"unknown mode {args.mode}")


if __name__ == "__main__":
    main()
