"""The port's run_matrix (unet_research_tpu_torch/cli/run_matrix.py) against
the JAX package's, on the tree of tests/test_cli.py and a tiny model
(-filters 4 -model_depth 2 -group_norm_groups 2).

The JAX package trains BM-1 once (`-stage train`); its out_root is copied.
JAX then runs `-stage all --with_dependent` on the original, and the port
`-stage all --with_dependent -device cpu` on the copy: both skip training,
and the port's test, uncertainty and density stages read JAX's msgpack
checkpoint. The two trees hold the same files. Tolerances, as for the CLIs
(tests/test_torch_cli.py): the test stage's segmentations to 1e-5, AUROC to
1e-6, F1 and accuracy equal; the rotational mean to 1e-4 and std to 2e-4.
The MC tensors have the same shapes; their masks differ by design (one seed
gives other masks in the two packages). `--dry_run` prints JAX's commands
with the package name swapped, and a rerun skips at least as many stages
as JAX's."""

import contextlib
import io
import os
import shutil
from os.path import join

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from unet_research_tpu.cli import run_matrix as jax_run_matrix
from unet_research_tpu_torch.cli import run_matrix

SMALL = ["-filters", "4", "-model_depth", "2", "-group_norm_groups", "2",
         "--auto_lr_find", "False"]
STAGE_FLAGS = ["-models", "BM-1", "-num_epochs", "1", "-seed", "5",
               "-iter_num", "8", "-num_iterations", "6", "-chunk", "4",
               "-save_num", "2", "-block_size", "3", "-reuse_tensors"] + SMALL


def _aug_tree(root):
    """The augmented-layout tree of tests/test_cli.py:21-42."""
    rng = np.random.default_rng(0)
    for split, n, with_targets in [("train", 6, True), ("val", 2, True), ("test", 2, False)]:
        d = root / split
        (d / "images").mkdir(parents=True)
        (d / "masks").mkdir()
        if with_targets:
            (d / "targets").mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (32, 32)).astype(np.uint8)).save(
                d / "images" / f"{i}_image.png")
            Image.fromarray(np.full((32, 32), 255, np.uint8)).save(d / "masks" / f"{i}_mask.png")
            if with_targets:
                Image.fromarray(((rng.random((32, 32)) > 0.5) * 255).astype(np.uint8)).save(
                    d / "targets" / f"{i}_target.png")
    return str(root)


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    root = tmp_path_factory.mktemp("matrix")
    data = _aug_tree(root / "aug")
    jax_root, port_root = str(root / "jax"), str(root / "port")
    base = ["-data_path", data] + STAGE_FLAGS + ["--with_dependent"]
    _run(jax_run_matrix.main, ["-stage", "train", "-out_root", jax_root] + base)
    shutil.copytree(jax_root, port_root, symlinks=True)
    logs = {
        "jax": _run(jax_run_matrix.main, ["-stage", "all", "-out_root", jax_root] + base),
        "port": _run(run_matrix.main,
                     ["-stage", "all", "-out_root", port_root] + base + ["-device", "cpu"]),
        "jax_rerun": _run(jax_run_matrix.main, ["-stage", "all", "-out_root", jax_root] + base),
        "port_rerun": _run(run_matrix.main,
                           ["-stage", "all", "-out_root", port_root] + base + ["-device", "cpu"]),
    }
    return {"jax": jax_root, "port": port_root, "data": data, "logs": logs}


def _files(root):
    return sorted(os.path.relpath(join(base, f), root)
                  for base, _, files in os.walk(root) for f in files)


def _load(*parts):
    return torch.load(join(*parts)).numpy()


def test_both_skip_training_and_write_the_same_tree(matrices):
    for who in ("jax", "port"):
        assert "skip train BM-1: checkpoint exists" in matrices["logs"][who]
    assert "python -m unet_research_tpu_torch.cli.create_density" in matrices["logs"]["port"]
    jax_files, port_files = _files(matrices["jax"]), _files(matrices["port"])
    assert port_files == jax_files
    bm = "BM-1/"
    for need in ("test_statistics/val_images/metrics.csv",
                 "dropblock_uncertainty/tensors/image_0/std.pt",
                 "dropblock_uncertainty_dep/tensors/image_1/mean.pt",
                 "rotation_uncertainty/image_0/std.pt"):
        assert bm + need in port_files
    density = [f for f in port_files if f.startswith("density/")]
    assert "density/All_Models/BM-1_DvUD_STD.png" in density
    assert "density/Histograms/STD_InvDilated_Histogram_BM-1.png" in density
    assert len(density) == 31


def test_test_stage_matches_jax(matrices):
    ref = join(matrices["jax"], "BM-1", "test_statistics")
    out = join(matrices["port"], "BM-1", "test_statistics")
    for i in range(2):
        seg_ref = _load(ref, "val_images", "tensors", f"image_{i}", "segmentation.pt")
        seg = _load(out, "val_images", "tensors", f"image_{i}", "segmentation.pt")
        np.testing.assert_allclose(seg, seg_ref, atol=1e-5)
        # every pixel is in the FOV. A pixel whose channels the last ReLU
        # zeroes is exactly 0.5 in both packages (the head has no bias); every
        # other pixel lies farther from 0.5 than the two packages lie apart,
        # so both threshold it alike and F1 and accuracy can agree
        tie = seg_ref == 0.5
        assert (seg[tie] == 0.5).all()
        apart = np.abs(seg - seg_ref).max()
        assert not ((np.abs(seg_ref - 0.5) <= apart) & ~tie).any()
    jdf = pd.read_csv(join(ref, "val_images", "metrics.csv"))
    pdf = pd.read_csv(join(out, "val_images", "metrics.csv"))
    assert list(pdf.columns) == list(jdf.columns) and len(pdf) == 2
    for col in ("Validation_Image", "F1_Vessel", "Accuracy_Vessel"):
        assert (pdf[col] == jdf[col]).all(), col
    np.testing.assert_allclose(pdf["AUROC_Vessel"], jdf["AUROC_Vessel"], rtol=0, atol=1e-6)


def test_uncertainty_stages_match_jax(matrices):
    for i in range(2):
        ref = join(matrices["jax"], "BM-1", "rotation_uncertainty", f"image_{i}")
        out = join(matrices["port"], "BM-1", "rotation_uncertainty", f"image_{i}")
        np.testing.assert_allclose(_load(out, "mean.pt"), _load(ref, "mean.pt"), atol=1e-4)
        np.testing.assert_allclose(_load(out, "std.pt"), _load(ref, "std.pt"), atol=2e-4)
        for run in ("dropblock_uncertainty", "dropblock_uncertainty_dep"):
            for name in ("mean", "std", "tensors"):
                parts = (run, "tensors", f"image_{i}", f"{name}.pt")
                a = _load(matrices["port"], "BM-1", *parts)
                b = _load(matrices["jax"], "BM-1", *parts)
                assert a.shape == b.shape and a.dtype == b.dtype == np.float32
                assert np.isfinite(a).all()


def test_density_stage_magnitudes_are_finite(matrices):
    for kind in ("db", "rot"):
        df = pd.read_csv(join(matrices["port"], "density", f"std_magnitudes_{kind}.csv"))
        assert (df["model_name"] == "BM-1").all() and len(df) == 2
        assert np.isfinite(df[["min", "max", "mean", "std"]].to_numpy()).all()
    allm = pd.read_csv(join(matrices["port"], "density", "all_metrics.csv"))
    assert list(allm["name"]) == ["BM-1", "BM-1", "BM-1_DB", "BM-1_DB"]


def test_rerun_skips_like_jax(matrices):
    logs = matrices["logs"]
    assert logs["port_rerun"].count("skip") >= logs["jax_rerun"].count("skip") >= 5
    assert not os.path.exists(join(matrices["port"], "BM-1") + "0")
    assert not os.path.exists(join(matrices["port"], "BM-1", "dropblock_uncertainty0"))


@pytest.mark.parametrize("stage", ["train", "all"])
def test_dry_run_prints_jax_commands(matrices, tmp_path, stage):
    argv = ["-stage", stage, "-data_path", matrices["data"], "-out_root", str(tmp_path / "m"),
            "--dry_run", "--with_dependent"]
    ref = _run(jax_run_matrix.main, argv).replace("unet_research_tpu.cli.",
                                                  "unet_research_tpu_torch.cli.")
    out = _run(run_matrix.main, argv)
    assert out == ref
    assert out.count("[run_matrix]") == (12 if stage == "train" else 12 * 5 + 1)
    assert not os.path.exists(tmp_path / "m")
