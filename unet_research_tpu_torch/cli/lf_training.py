"""Low-fidelity training CLI: LFT / HFT / LFT-UP policies (twin of
unet_research_tpu/cli/lf_training.py).

One entry point replaces the reference's three LF forks
(multi-fidelity/LF-training-{LFT,HFT,LFT-UP}.py): train at -new_size^2
(LFT: test there too; HFT: test at native resolution; LFT-UP: degrade
down->up at full resolution). All use the independent-channel DropBlock
and take -train_ratio sequential truncation (LF-training-LFT.py:242-243,338).

Usage:
  python -m unet_research_tpu_torch.cli.lf_training -policy hft -mode train \
      -data_path AUG -save_path OUT -new_size 256 [-train_ratio .3]
"""

from __future__ import annotations

import argparse
import math

from unet_research_tpu_torch.cli import common
from unet_research_tpu_torch.train import Trainer, lf_policy


def make_trainer(args, remat: bool = True) -> Trainer:
    return common.make_trainer(args, lf_policy(args.policy, args.new_size), "independent", remat)


def training(args) -> str:
    dest = common.make_output_dir(args)
    train_ds, val_ds, test_ds = common.load_datasets(args.data_path)
    if args.train_ratio != 1.0:
        train_ds = train_ds.subset(math.ceil(args.train_ratio * len(train_ds)))
    return common.fit_and_score(make_trainer(args), dest, train_ds, val_ds, test_ds)


def testing(args) -> str:
    return common.score_checkpoint(args, make_trainer)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_train_args(parser)
    parser.add_argument("-policy", dest="policy", choices=["lft", "hft", "lft-up"], default="lft")
    parser.add_argument("-new_size", dest="new_size", type=int, default=32,
                        help="square training resolution (LF-training-LFT.py:336)")
    parser.add_argument("-train_ratio", dest="train_ratio", type=float, default=1.0)
    common.add_arch_args(parser)
    common.add_trainer_args(parser)
    return parser


def main(argv=None):
    return common.run_cli(main, build_parser, lambda args: common.run_mode(args, training, testing),
                          argv, split="train_batch")


if __name__ == "__main__":
    main()
