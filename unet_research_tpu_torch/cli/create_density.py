"""Density-analysis CLI (twin of unet_research_tpu/cli/create_density.py:
the reference's create_density.py qsub launcher and its three analysis
payload scripts, consolidated).

Usage:
  python -m unet_research_tpu_torch.cli.create_density -results_root RUNS \
      -save_path RUNS/density [-aug_root AUG] [-kinds std,cv,did,hist] \
      [-models BM-1,...] [-device cuda|cpu]

The default kinds are 'std,cv'; 'did' (the dependent-vs-independent
overlays, which need a run_matrix --with_dependent tree) and 'hist' are
opt-in. The KDE runs on `-device` (default: the card; without one the
command raises before it reads or writes anything).
"""

from __future__ import annotations

import argparse

from unet_research_tpu_torch.evaluation.density import MODELS, create_density_report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-results_root", dest="results_root", required=True)
    parser.add_argument("-save_path", dest="save_path", required=True)
    parser.add_argument("-aug_root", dest="aug_root", default=None,
                        help="augmented data root (for FOV masks in CV plots)")
    parser.add_argument("-kinds", dest="kinds", default="std,cv")
    parser.add_argument("-models", dest="models", default=",".join(MODELS))
    parser.add_argument("-device", dest="device", choices=("cuda", "cpu"), default="cuda",
                        help="where the KDE runs: the card (default) or the CPU")
    args, _ = parser.parse_known_args(argv)
    create_density_report(
        args.results_root,
        args.save_path,
        aug_root=args.aug_root,
        models=[m for m in args.models.split(",") if m],
        kinds=tuple(args.kinds.split(",")),
        device=args.device,
    )
    print(f"density report written to {args.save_path}")


if __name__ == "__main__":
    main()
