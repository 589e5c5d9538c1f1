"""MC-DropBlock uncertainty CLI (twin of
unet_research_tpu/cli/dropblock_uncertainty.py; reference
uncertainty_tests/Dropblock_Uncertainty.py).

Phase 1 ('save'): per validation image, an -iter_num member Monte-Carlo
DropBlock ensemble (reference default 1000) in chunked batches; saves
tensors/image_{i}/{mean,std,tensors}.pt (Dropblock_Uncertainty.py:154-165).
Phase 2 ('evaluate'): the ensemble mean is scored with
final_test_metrics(disable_test=True) (Dropblock_Uncertainty.py:167-172).
Like the reference, the evaluate phase draws the ensemble afresh;
-reuse_tensors reuses the phase-1 means instead.

The site keys of image i come from a generator seeded from (seed, i), those
of its evaluate pass from (seed, 100000 + i), as the JAX CLI folds i and
100000 + i into its key (:64, :71, :101). The two packages draw different
masks from one seed (their generators differ).

Usage:
  python -m unet_research_tpu_torch.cli.dropblock_uncertainty -model_path CKPT \\
      -data_path AUG -save_path OUT [-independent_drop] [-iter_num 1000]
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np
import torch

from unet_research_tpu_torch.cli import common
from unet_research_tpu_torch.data.loading import batch_iterator
from unet_research_tpu_torch.evaluation import artifacts
from unet_research_tpu_torch.evaluation.metrics import final_test_metrics
from unet_research_tpu_torch.ops.image import engine_input
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine
from unet_research_tpu_torch.utils.convert import load_model_checkpoint
from unet_research_tpu_torch.utils.general import create_dir, seed_everything


def image_generator(seed: int, index: int) -> torch.Generator:
    """The site-key generator of image `index` in a run seeded `seed`."""
    words = np.random.SeedSequence([seed % 2**64, index]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))


def _host(*tensors):
    return tuple(t.cpu().numpy() for t in tensors)


def test_uncertainty(args) -> str | None:
    """Both phases; under a mesh every rank runs the engine on its members
    and rank 0 alone writes (the other ranks return None)."""
    if args.seed != -1:
        seed_everything(args.seed)
    writes = common.rank0(args)
    stats = create_dir(args.save_path) if writes else None
    if writes and stats is None:
        raise SystemExit(1)
    if writes:
        os.symlink(os.path.abspath(args.model_path), join(stats, "model_ckpt_symlink.ckpt"))

    _, val_ds, test_ds = common.load_datasets(args.data_path, with_train=False)
    model = common.build_network(
        args, dropblock_kind="independent" if args.independent else "dependent",
        use_scheduler=False, drop_prob=args.drop_prob)
    model.load_state_dict(load_model_checkpoint(args.model_path, model.cfg)[0])
    engine = MCDropBlockEngine(model, num_iterations=args.iter_num, return_num=args.save_num,
                               resize=args.resize, chunk=args.chunk, device=args.device,
                               mesh=args.mesh)
    seed = args.seed if args.seed != -1 else 0

    # phase 1: save tensors (Dropblock_Uncertainty.py:152-165)
    tens = join(stats, "tensors") if writes else None
    if writes:
        os.makedirs(tens)
    means = {}
    for i, (im, gt, mask) in enumerate(batch_iterator(val_ds, 1, False, device=args.device)):
        mean, std, saved = _host(*engine.predict(im, gt, mask, args.drop_prob,
                                                 generator=image_generator(seed, i))[:3])
        means[i] = mean
        if not writes:
            continue
        im_dir = join(tens, f"image_{i}")
        os.makedirs(im_dir)
        artifacts.save_tensor_batched(mean, join(im_dir, "mean.pt"))
        artifacts.save_tensor_batched(std, join(im_dir, "std.pt"))
        artifacts.save_stacked_tensors(saved, join(im_dir, "tensors.pt"))
        print(f"saved MC tensors for image {i}")

    # phase 2: evaluate the MC mean (Dropblock_Uncertainty.py:167-172)
    def mc_predict(ds):
        for i, (im, gt, mask) in enumerate(batch_iterator(ds, 1, False, device=args.device)):
            if args.reuse_tensors and i in means:
                mean = means[i]
                im2, gt2, mask2 = _host(*(engine_input(t, args.device, args.resize)
                                          for t in (im, gt, mask)))
            else:
                mean, _, _, im2, gt2, mask2 = _host(*engine.predict(
                    im, gt, mask, args.drop_prob, generator=image_generator(seed, 100_000 + i)))
            yield i, mean, im2, gt2, mask2

    if not writes:
        for _ in mc_predict(val_ds):  # the ensembles rank 0's scoring runs
            pass
        return None
    statistics = join(stats, "statistics")
    os.makedirs(statistics)
    final_test_metrics(mc_predict, val_ds, test_ds, statistics, disable_test=True)
    return stats


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("-model_path", dest="model_path", required=True, type=str)
    parser.add_argument("-data_path", dest="data_path", required=True)
    parser.add_argument("-save_path", dest="save_path", required=True)
    parser.add_argument("-block_size", dest="block_size", type=int, default=7)
    parser.add_argument("-drop_prob", dest="drop_prob", type=float, default=0.15)
    parser.add_argument("-independent_drop", dest="independent", action="store_true")
    parser.add_argument("-iter_num", dest="iter_num", type=int, default=1000)
    parser.add_argument("-save_num", dest="save_num", type=int, default=0)
    parser.add_argument("-resize", dest="resize", type=int, default=-1)
    parser.add_argument("-seed", dest="seed", type=int, default=-1)
    parser.add_argument("-chunk", dest="chunk", type=int, default=16,
                        help="ensemble members per batched forward")
    parser.add_argument("-reuse_tensors", dest="reuse_tensors", action="store_true",
                        help="reuse phase-1 means in the evaluate phase")
    # the reference forwards max_drop_prob/dropblock_steps via the shared
    # surface; they only build the module (the scheduler is off here)
    parser.add_argument("-max_drop_prob", dest="max_drop_prob", type=float, default=0.15)
    parser.add_argument("-dropblock_steps", dest="dropblock_steps", type=int, default=1500)
    common.add_arch_args(parser)
    common.add_trainer_args(parser)
    return parser


def main(argv=None):
    return common.run_cli(main, build_parser, test_uncertainty, argv, split="chunk")


if __name__ == "__main__":
    main()
