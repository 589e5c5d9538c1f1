"""Multi-fidelity inference sweep: evaluate a trained model at arbitrary
height x width resolutions (twin of unet_research_tpu/cli/base_model_mf.py).

The reference README documents `base_model_mf.py -height H -width W`
(README.md:139-170), but the script is absent from its tree (superseded by
the MF/LF forks). This entry point restores the capability once: each
requested resolution gets a full metrics pass (square-pad -> bilinear
resize of image, target and mask -> a DropBlock-free forward -> FOV-masked
F1/AUROC/accuracy at that resolution), written to save_path/{H}x{W}/.

-height/-width take comma-separated lists for a sweep in one call; a
single width is used with every height:
  python -m unet_research_tpu_torch.cli.base_model_mf -model_path CKPT \
      -data_path AUG -save_path OUT -height 32,64,128,256 -width 32,64,128,256
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np

from unet_research_tpu_torch.cli import common
from unet_research_tpu_torch.data.loading import batch_iterator
from unet_research_tpu_torch.evaluation.metrics import final_test_metrics
from unet_research_tpu_torch.ops.image import resize_bilinear, square_pad
from unet_research_tpu_torch.train.loop import ForwardProgram
from unet_research_tpu_torch.utils.convert import load_model_checkpoint


def predict_at(model, ds, h: int, w: int, program: bool = True, forward=None):
    """Trainer.predict's yield of (idx, seg, im, gt, mask) for `model`
    (weights loaded, on its device) with every image, target and mask
    square-padded and resized to h x w first, through `forward` (a
    train/loop.py::ForwardProgram, JAX's jitted predict_step), a new one
    when None; program=False (port-only) runs each forward from the host."""
    device = next(model.parameters()).device
    if forward is None:
        forward = ForwardProgram(device, capture=program)

    def predict_step(im, gt, mask):
        im, gt, mask = (resize_bilinear(square_pad(t), (h, w)) for t in (im, gt, mask))
        return model(im) * mask, im, gt, mask

    for i, batch in enumerate(batch_iterator(ds, 1, False, device=device)):
        out = forward("predict", predict_step, *batch)
        yield (i, *(t.cpu().numpy() for t in out))


def evaluate_at(model, val_ds, test_ds, h: int, w: int, out_dir: str,
                program: bool = True) -> dict:
    """final_test_metrics of `model` at h x w into out_dir; the val and test
    forwards share one forward program (program=False: from the host),
    freed on return."""
    os.makedirs(out_dir, exist_ok=True)
    forward = ForwardProgram(next(model.parameters()).device, capture=program)
    return final_test_metrics(lambda ds: predict_at(model, ds, h, w, forward=forward), val_ds,
                              test_ds, out_dir)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-model_path", dest="model_path", required=True)
    parser.add_argument("-data_path", dest="data_path", required=True)
    parser.add_argument("-save_path", dest="save_path", required=True)
    parser.add_argument("-height", dest="height", type=str, default="256")
    parser.add_argument("-width", dest="width", type=str, default="256")
    parser.add_argument("-seed", dest="seed", type=int, default=-1)
    parser.add_argument("-block_size", dest="block_size", type=int, default=7)
    parser.add_argument("-max_drop_prob", dest="max_drop_prob", type=float, default=0.15)
    parser.add_argument("-dropblock_steps", dest="dropblock_steps", type=int, default=1500)
    common.add_arch_args(parser)
    common.add_trainer_args(parser)
    return parser


def main(argv=None):
    args = common.parse_with_passthrough(build_parser(), argv)
    heights = [int(x) for x in str(args.height).split(",")]
    widths = [int(x) for x in str(args.width).split(",")]
    if len(widths) == 1:
        widths = widths * len(heights)
    if len(heights) != len(widths):
        raise ValueError(f"-height has {len(heights)} sizes but -width {len(widths)}")
    dest = common.make_output_dir(args)

    _, val_ds, test_ds = common.load_datasets(args.data_path, with_train=False)
    model = common.build_network(args, dropblock_kind=None, use_scheduler=False)
    sd, _ = load_model_checkpoint(args.model_path, model.cfg)
    model.load_state_dict(sd)
    model.eval()
    for h, w in zip(heights, widths):
        metrics = evaluate_at(model, val_ds, test_ds, h, w, join(dest, f"{h}x{w}"))
        print(f"{h}x{w}: mean F1 {np.mean(metrics['F1_Vessel']):.4f}")
    return dest


if __name__ == "__main__":
    main()
