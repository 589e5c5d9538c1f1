"""Experiment-matrix runner (twin of unet_research_tpu/cli/run_matrix.py):
the reference's PBS/qsub fleet as one CLI.

The reference launches its 12-model matrix by shelling out qsub strings
(training_script.py:16-30, testing_script.py:17-39,
uncertainty_tests/uncertainty_script.py:20-28, create_density.py:3-5) whose
.sh payloads are gitignored. This runner encodes the same matrix
declaratively and executes the stages in-process, one after the other on
one card, or prints the equivalent commands with --dry_run.

The 12 models (training_script.py:16-30):
  BM-1/2/3: base training at train_ratio 1, 4/14, 2/14
  MF-1/2/3: UNI / RAT / RSZ-RAT
  LF-1/3/5: HFT at new_size 256,128,256 (ratio 1,1,4/14)
  LF-2/4/6: LFT at the same grid

The uncertainty stage's resize mirrors uncertainty_script.py:20-28: LF
models are evaluated at their training resolution, the others at native
size. Output directories are the names the density and viewer stages read
(evaluation/density.py load_matrix_tensors, cli/view_tensors.py):
<model>/dropblock_uncertainty, <model>/rotation_uncertainty, and (with
--with_dependent) <model>/dropblock_uncertainty_dep for the DID overlays.

Unknown flags pass through to every stage: `-device cpu` runs the matrix on
the CPU (every stage defaults to the card), `-warp shear` selects the
rotational stage's fan warp. The test and uncertainty stages read the first
checkpoint of <model>/model_info, the port's own or a JAX msgpack one, so
the port resumes a matrix the JAX package trained.

Reruns are idempotent: a stage whose output dir already exists is skipped
(so a crashed fleet resumes where it stopped); --force moves the existing
dir aside to <dir>.bak{N} and reruns — stages always read/write the
canonical paths, never create_dir's suffix-retried ones.
"""

from __future__ import annotations

import argparse
import os
import shlex
import shutil
from os.path import exists, join

MATRIX = {
    "BM-1": ("training", ["-train_ratio", "1"]),
    "BM-2": ("training", ["-train_ratio", str(4 / 14)]),
    "BM-3": ("training", ["-train_ratio", str(2 / 14)]),
    "MF-1": ("mf_training", ["-policy", "uni"]),
    "MF-2": ("mf_training", ["-policy", "rat"]),
    "MF-3": ("mf_training", ["-policy", "rsz-rat"]),
    "LF-1": ("lf_training", ["-policy", "hft", "-new_size", "256"]),
    "LF-2": ("lf_training", ["-policy", "lft", "-new_size", "256"]),
    "LF-3": ("lf_training", ["-policy", "hft", "-new_size", "128"]),
    "LF-4": ("lf_training", ["-policy", "lft", "-new_size", "128"]),
    "LF-5": ("lf_training", ["-policy", "hft", "-new_size", "256", "-train_ratio", str(4 / 14)]),
    "LF-6": ("lf_training", ["-policy", "lft", "-new_size", "256", "-train_ratio", str(4 / 14)]),
}

# resize used by the uncertainty stage per model (uncertainty_script.py:20-28)
UNCERTAINTY_RESIZE = {
    "LF-1": 256, "LF-2": 256, "LF-5": 256, "LF-6": 256,
    "LF-3": 128, "LF-4": 128,
}


def _run_module(module: str, argv: list[str], dry: bool) -> None:
    cmd = f"python -m unet_research_tpu_torch.cli.{module} " + " ".join(map(shlex.quote, argv))
    print(f"[run_matrix] {cmd}")
    if dry:
        return
    import importlib

    mod = importlib.import_module(f"unet_research_tpu_torch.cli.{module}")
    mod.main(argv)


def _claim(path: str, force: bool, dry: bool) -> bool:
    """True if the stage should run into `path`. Existing outputs are
    skipped (idempotent resume) unless --force, which moves them aside to
    <path>.bak{N} so every stage reads/writes canonical names (no
    create_dir suffix drift, reference utils_general.py:15-30)."""
    if dry or not exists(path):
        return True
    if not force:
        print(f"[run_matrix] skip: {path} exists (use --force to redo)")
        return False
    n = 0
    while exists(f"{path}.bak{n}"):
        n += 1
    shutil.move(path, f"{path}.bak{n}")
    print(f"[run_matrix] moved aside {path} -> {path}.bak{n}")
    return True


def stage_train(args, models):
    for name in models:
        module, extra = MATRIX[name]
        mdir = join(args.out_root, name)
        # a completed training leaves model_info/*.ckpt; treat anything
        # else (crashed run) as stale and move it aside
        done = exists(join(mdir, "model_info")) and any(
            f.endswith(".ckpt") and not os.path.islink(join(mdir, "model_info", f))
            for f in os.listdir(join(mdir, "model_info"))
        ) if exists(join(mdir, "model_info")) else False
        if not args.dry_run and exists(mdir):
            if done and not args.force:
                print(f"[run_matrix] skip train {name}: checkpoint exists (use --force)")
                continue
            if not _claim(mdir, True, args.dry_run):
                continue
        argv = [
            "-mode", "train",
            "-data_path", args.data_path,
            "-save_path", mdir,
            "-seed", str(args.seed),
            "-num_epochs", str(args.num_epochs),
        ] + extra + args.extra
        _run_module(module, argv, args.dry_run)


def stage_test(args, models):
    """Per-model -mode test with the best checkpoint (the reference's
    testing_script.py:17-39)."""
    from unet_research_tpu_torch.train.checkpoint import find_checkpoint

    for name in models:
        module, extra = MATRIX[name]
        out = join(args.out_root, name, "test_statistics")
        if not _claim(out, args.force, args.dry_run):
            continue
        ckpt = "<best.ckpt>" if args.dry_run else find_checkpoint(join(args.out_root, name, "model_info"))
        argv = [
            "-mode", "test",
            "-model_path", ckpt,
            "-data_path", args.data_path,
            "-save_path", out,
            "-seed", str(args.seed),
        ] + extra + args.extra
        _run_module(module, argv, args.dry_run)


def stage_uncertainty(args, models):
    from unet_research_tpu_torch.train.checkpoint import find_checkpoint

    jobs = [
        ("dropblock_uncertainty", "dropblock_uncertainty", ["-independent_drop"]),
        ("rotation_uncertainty", "rotational_uncertainty", []),
    ]
    if args.with_dependent:
        # second MC run with the dependent DropBlock2D — the comparison set
        # create_density_DID.py analyzes (density.py reads *_dep)
        jobs.insert(1, ("dropblock_uncertainty_dep", "dropblock_uncertainty", []))
    for name in models:
        resize = UNCERTAINTY_RESIZE.get(name, -1)
        ckpt = "<best.ckpt>" if args.dry_run else find_checkpoint(join(args.out_root, name, "model_info"))
        for out_name, module, extra in jobs:
            out = join(args.out_root, name, out_name)
            if not _claim(out, args.force, args.dry_run):
                continue
            argv = [
                "-model_path", ckpt,
                "-data_path", args.data_path,
                "-save_path", out,
                "-resize", str(resize),
                "-seed", str(args.seed),
            ] + extra + args.extra
            _run_module(module, argv, args.dry_run)


def stage_density(args, models):
    kinds = "std,cv,hist,did" if args.with_dependent else "std,cv,hist"
    argv = [
        "-results_root", args.out_root,
        "-save_path", join(args.out_root, "density"),
        "-aug_root", args.data_path,
        "-models", ",".join(models),
        "-kinds", kinds,
    ] + args.extra
    _run_module("create_density", argv, args.dry_run)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-stage", choices=["train", "test", "uncertainty", "density", "all"], default="all")
    parser.add_argument("-data_path", required=True)
    parser.add_argument("-out_root", required=True)
    parser.add_argument("-models", default=",".join(MATRIX), help="comma list of model names")
    parser.add_argument("-seed", type=int, default=1234)
    parser.add_argument("-num_epochs", type=int, default=50)
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--force", action="store_true",
                        help="redo stages whose outputs exist (moved to .bakN)")
    parser.add_argument("--with_dependent", action="store_true",
                        help="also run the dependent-DropBlock MC set (for -kinds did)")
    args, extra = parser.parse_known_args(argv)
    args.extra = extra
    models = [m for m in args.models.split(",") if m]
    unknown = set(models) - set(MATRIX)
    if unknown:
        raise SystemExit(f"unknown models: {sorted(unknown)}")

    if args.stage in ("train", "all"):
        stage_train(args, models)
    if args.stage in ("test", "all"):
        stage_test(args, models)
    if args.stage in ("uncertainty", "all"):
        stage_uncertainty(args, models)
    if args.stage in ("density", "all"):
        stage_density(args, models)


if __name__ == "__main__":
    main()
