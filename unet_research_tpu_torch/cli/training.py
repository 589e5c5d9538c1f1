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

from unet_research_tpu_torch.cli import common
from unet_research_tpu_torch.train import POLICIES, Trainer
from unet_research_tpu_torch.utils.convert import checkpoint_format


def make_trainer(args, policy_name: str = "none", remat: bool = True) -> Trainer:
    return common.make_trainer(args, POLICIES[policy_name], "dependent", remat)


def training(args) -> str:
    if args.resume_from is not None and checkpoint_format(args.resume_from) != "torch":
        raise ValueError(f"-resume_from {args.resume_from}: a JAX checkpoint's optimizer "
                         "state is not carried over; resume from a checkpoint of this port")
    dest = common.make_output_dir(args)
    train_ds, val_ds, test_ds = common.load_datasets(args.data_path)
    if args.train_ratio != 1.0:
        train_ds = train_ds.subset(math.ceil(args.train_ratio * len(train_ds)))
    trainer = make_trainer(args, "red" if args.train_ratio != 1.0 else "none")
    return common.fit_and_score(trainer, dest, train_ds, val_ds, test_ds,
                                resume_from=args.resume_from)


def testing(args) -> str:
    return common.score_checkpoint(args, make_trainer)


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
    return common.run_cli(main, build_parser, lambda args: common.run_mode(args, training, testing),
                          argv, split="train_batch")


if __name__ == "__main__":
    main()
