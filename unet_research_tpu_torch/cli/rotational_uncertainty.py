"""Rotational-TTA uncertainty CLI (twin of
unet_research_tpu/cli/rotational_uncertainty.py; reference
uncertainty_tests/Rotational_Uncertainty.py).

Per validation image: a -num_iterations member rotate -> forward ->
unrotate ensemble (359 in the reference, Rotational_Uncertainty.py:127) in
chunked batches. Saves image_{i}/{mean,std,tensors}.pt directly under the
stats dir (Rotational_Uncertainty.py:136-144: unlike the dropblock CLI, no
tensors/ folder). The model runs with DropBlock off.

Usage:
  python -m unet_research_tpu_torch.cli.rotational_uncertainty -model_path CKPT \\
      -data_path AUG -save_path OUT [-resize 256] [-save_num 25] [-warp shear]
"""

from __future__ import annotations

import argparse
import os
from os.path import join

from unet_research_tpu_torch.cli import common
from unet_research_tpu_torch.data.loading import batch_iterator
from unet_research_tpu_torch.evaluation import artifacts
from unet_research_tpu_torch.uncertainty import RotationalEngine
from unet_research_tpu_torch.utils.convert import load_model_checkpoint
from unet_research_tpu_torch.utils.general import create_dir, seed_everything


def test_uncertainty(args) -> str:
    if args.seed != -1:
        seed_everything(args.seed)
    stats = create_dir(args.save_path)
    if stats is None:
        raise SystemExit(1)
    os.symlink(os.path.abspath(args.model_path), join(stats, "model_ckpt_symlink.ckpt"))

    _, val_ds, _ = common.load_datasets(args.data_path, with_train=False)
    model = common.build_network(args, dropblock_kind=None, use_scheduler=False)
    model.load_state_dict(load_model_checkpoint(args.model_path, model.cfg)[0])
    engine = RotationalEngine(model, num_iterations=args.num_iterations,
                              return_num=args.save_num, resize=args.resize, chunk=args.chunk,
                              warp=args.warp, device=args.device)

    for i, (im, gt, mask) in enumerate(batch_iterator(val_ds, 1, False, device=args.device)):
        mean, std, saved = (t.cpu().numpy() for t in engine.predict(im, gt, mask)[:3])
        im_dir = join(stats, f"image_{i}")
        os.makedirs(im_dir)
        artifacts.save_tensor_batched(mean, join(im_dir, "mean.pt"))
        artifacts.save_tensor_batched(std, join(im_dir, "std.pt"))
        artifacts.save_stacked_tensors(saved, join(im_dir, "tensors.pt"))
        print(f"saved rotational tensors for image {i}")
    return stats


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-model_path", dest="model_path", required=True, type=str)
    parser.add_argument("-data_path", dest="data_path", required=True)
    parser.add_argument("-save_path", dest="save_path", required=True)
    parser.add_argument("-save_num", dest="save_num", type=int, default=0)
    parser.add_argument("-resize", dest="resize", type=int, default=-1)
    parser.add_argument("-seed", dest="seed", type=int, default=-1)
    parser.add_argument("-num_iterations", dest="num_iterations", type=int, default=359,
                        help="rotation fan size (the reference hardcodes 359)")
    parser.add_argument("-chunk", dest="chunk", type=int, default=16)
    parser.add_argument("-warp", dest="warp", choices=("shear", "gather"), default="gather",
                        help="rotation: 'gather' (torchvision-bilinear parity, the "
                        "reference's interpolation) or 'shear' (the three-shear fan "
                        "warp, kernel K4; about 1e-3 mean abs from bilinear)")
    parser.add_argument("-block_size", dest="block_size", type=int, default=7)
    parser.add_argument("-max_drop_prob", dest="max_drop_prob", type=float, default=0.15)
    parser.add_argument("-dropblock_steps", dest="dropblock_steps", type=int, default=1500)
    common.add_arch_args(parser)
    common.add_trainer_args(parser)
    return parser


def main(argv=None):
    return test_uncertainty(common.parse_with_passthrough(build_parser(), argv))


if __name__ == "__main__":
    main()
