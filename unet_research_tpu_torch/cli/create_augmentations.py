"""Augmented-dataset generation CLI (twin of
unet_research_tpu/cli/create_augmentations.py; reference
preprocessing/create_augmentations.py: -dest/-seed, DRIVE paths relative to
the working directory; -data_root points at any DRIVE checkout).

Usage:
  python -m unet_research_tpu_torch.cli.create_augmentations -dest augmented_data \
      -seed 1234 [-data_root /path/to/Unet_research/datasets] [-device cpu]
"""

from __future__ import annotations

import argparse

from unet_research_tpu_torch.data.augment import create_augmentations
from unet_research_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-dest", dest="dest", type=str, default="augmented_data")
    parser.add_argument("-seed", dest="seed", type=int, default=1234)
    parser.add_argument(
        "-data_root", dest="data_root", type=str, default="datasets",
        help="DRIVE root containing training/ and test/ (reference uses ./datasets)")
    parser.add_argument("-num_train", dest="num_train", type=int, default=36,
                        help="augments per train image (hardcoded 36 upstream)")
    parser.add_argument("-device", dest="device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run the warps: the card (default) or the CPU")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    out = create_augmentations(args.data_root, args.dest, args.seed, args.num_train,
                               device=device)
    print(f"augmented dataset written to {out}")
    return out


if __name__ == "__main__":
    main()
