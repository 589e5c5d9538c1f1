"""Multi-fidelity training CLI: UNI / RAT / RSZ-RAT policies (twin of
unet_research_tpu/cli/mf_training.py).

One entry point replaces the reference's three forked scripts
(multi-fidelity/MF-training-{UNI,RAT,RSZ-RAT}.py, identical except for the
size-plan ratios and degrade-in-place behaviour). All MF scripts use the
independent-channel DropBlock (MF-training-UNI.py:244) and an UNSHUFFLED
train loader so that batch_idx indexes the per-image size plan
(MF-training-UNI.py:227).

Usage:
  python -m unet_research_tpu_torch.cli.mf_training -policy uni -mode train \
      -data_path AUG -save_path OUT -orig_train_size 14 -num_augmentations 36
  python -m unet_research_tpu_torch.cli.mf_training -policy rat -mode test \
      -model_path CKPT -data_path AUG -save_path OUT
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from unet_research_tpu_torch.cli import common
from unet_research_tpu_torch.parallel.mesh import broadcast_
from unet_research_tpu_torch.train import POLICIES, Trainer, make_size_plan


def make_trainer(args, remat: bool = True) -> Trainer:
    return common.make_trainer(args, POLICIES[args.policy], "independent", remat)


def size_plan_for(args, n_train: int, mesh=None) -> np.ndarray:
    """The per-item size plan (make_size_plan from a generator seeded with
    -seed), cycled or truncated to the n_train items, as JAX
    mf_training.py:61-71 does. Under `mesh` every rank takes rank 0's (an
    unseeded -seed -1 draws differently on each)."""
    plan_rng = np.random.default_rng(args.seed if args.seed != -1 else None)
    size_plan = make_size_plan(args.policy, args.orig_train_size, args.num_augmentations, plan_rng)
    if len(size_plan) != n_train:
        if mesh is None or mesh.rank == 0:
            print(f"[mf_training] size plan covers {len(size_plan)} items but train set"
                  f" has {n_train}; plan will be cycled/truncated like batch_idx")
        reps = -(-n_train // len(size_plan))
        size_plan = np.tile(size_plan, reps)[:n_train]
    if mesh is not None:
        plan = torch.from_numpy(size_plan.astype(np.int64)).to(mesh.device)
        size_plan = broadcast_(plan, mesh).cpu().numpy()
    return size_plan


def training(args) -> str:
    dest = common.make_output_dir(args)
    train_ds, val_ds, test_ds = common.load_datasets(args.data_path)
    size_plan = size_plan_for(args, len(train_ds), args.mesh)
    return common.fit_and_score(make_trainer(args), dest, train_ds, val_ds, test_ds,
                                size_plan=size_plan)


def testing(args) -> str:
    return common.score_checkpoint(args, make_trainer)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_train_args(parser)
    parser.add_argument("-policy", dest="policy", choices=["uni", "rat", "rsz-rat"], default="uni")
    parser.add_argument("-orig_train_size", dest="orig_train_size", type=int, default=14,
                        help="number of original (pre-augmentation) train images")
    parser.add_argument("-num_augmentations", dest="num_augmentations", type=int, default=36)
    common.add_arch_args(parser)
    common.add_trainer_args(parser)
    return parser


def main(argv=None):
    return common.run_cli(main, build_parser, lambda args: common.run_mode(args, training, testing),
                          argv, split="train_batch")


if __name__ == "__main__":
    main()
