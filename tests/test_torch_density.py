"""The port's density analysis (unet_research_tpu_torch/evaluation/density.py,
cli/create_density.py) against the JAX package's, which runs on sklearn,
pandas, cv2, PIL and matplotlib, on one seeded synthetic results tree: two
models with two validation images each, BM-1's tensors at 24x20 (the size
of the masks and targets) and LF-3's at 16x16, so that the nearest resize
of masks and targets runs.

Tolerances: the nearest resize, the erode, the FOV selection and the
(inverse-)dilated regions equal to cv2's and JAX's; each KDE curve within
1e-9 of its maximum of sklearn's (the same float64 sum in another order);
each histogram's counts and edges equal to np.histogram's on JAX's
selection; std_magnitudes_{db,rot}.csv and all_metrics.csv byte-equal;
the report's file set equal for the kinds std, cv, hist and did."""

import csv
import io
import os
from os.path import exists, join

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from unet_research_tpu.evaluation import density as jax_density
from unet_research_tpu_torch.cli import create_density
from unet_research_tpu_torch.evaluation import density

MODELS = {"BM-1": (24, 20), "LF-3": (16, 16)}
KINDS = ("std", "cv", "hist", "did")
SIZES = [((584, 565), (256, 256)), ((584, 565), (128, 128)), ((256, 256), (584, 565)),
         ((24, 20), (16, 16)), ((16, 16), (24, 20))]


def _results(root):
    rng = np.random.default_rng(0)
    for model, hw in MODELS.items():
        for kind, nest in (("dropblock_uncertainty", "tensors"), ("rotation_uncertainty", None),
                           ("dropblock_uncertainty_dep", "tensors")):
            base = root / "runs" / model / kind
            folder = base / nest if nest else base
            for i in range(2):
                d = folder / f"image_{i}"
                d.mkdir(parents=True)
                std = rng.random((1, 1, *hw)).astype(np.float32) * 0.3
                mean = rng.random((1, 1, *hw)).astype(np.float32)
                mean[0, 0, 0, :3] = 0.0  # 0/0 and x/0 in the CV selections
                std[0, 0, 0, 0] = 0.0
                torch.save(torch.from_numpy(std), d / "std.pt")
                torch.save(torch.from_numpy(mean), d / "mean.pt")
        for sub in ("statistics", "dropblock_uncertainty/statistics"):
            stats = root / "runs" / model / sub / "val_images"
            stats.mkdir(parents=True, exist_ok=True)
            (stats / "metrics.csv").write_text(
                "Validation_Image,F1_Vessel,AUROC_Vessel,Accuracy_Vessel\n"
                f"1,0.8123456789012345,0.9,{rng.random()!r}\n2,0.7071067811865476,,0.96\n")
    for sub in ("masks", "targets"):
        (root / "aug" / "val" / sub).mkdir(parents=True)
    for i in range(2):
        mask = np.full((24, 20), 255, np.uint8)
        mask[:3] = 0
        Image.fromarray(mask).save(root / "aug" / "val" / "masks" / f"{i}_mask.png")
        target = ((rng.random((24, 20)) > 0.7) * 255).astype(np.uint8)
        Image.fromarray(target).save(root / "aug" / "val" / "targets" / f"{i}_target.png")
    return str(root / "runs"), str(root / "aug")


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, record)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    root = tmp_path_factory.mktemp("density")
    runs, aug = _results(root)
    calls = {k: [] for k in ("jax_kde", "port_kde", "jax_hist", "port_hist")}
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, jax_density, "_kde_curve", calls["jax_kde"])
        _spy(mp, density, "_kde_curve", calls["port_kde"])
        _spy(mp, jax_density, "_save_hist", calls["jax_hist"])
        _spy(mp, density, "_histogram", calls["port_hist"])
        jax_density.create_density_report(runs, str(root / "jax"), aug, models=list(MODELS),
                                          kinds=KINDS)
        create_density.main(["-results_root", runs, "-save_path", str(root / "port"),
                             "-aug_root", aug, "-models", ",".join(MODELS),
                             "-kinds", ",".join(KINDS), "-device", "cpu"])
    return {"jax": str(root / "jax"), "port": str(root / "port"), "runs": runs, "aug": aug,
            **calls}


def _files(root):
    return sorted(os.path.relpath(join(base, f), root)
                  for base, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_nearest_and_erode_match_cv2(src, dst):
    rng = np.random.default_rng(src[0] + dst[1])
    a = rng.integers(0, 256, src).astype(np.uint8)
    want = cv2.resize(a, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(density.resize_nearest_cv2(a, dst), want)
    binary = ((rng.random(src) > 0.6) * 255).astype(np.uint8)
    np.testing.assert_array_equal(density.erode3x3(binary),
                                  cv2.erode(binary, np.ones((3, 3), np.uint8)))


@pytest.mark.parametrize("src,dst", SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_fov_and_dilated_regions_match_jax(src, dst, inverse):
    rng = np.random.default_rng(7)
    arr = rng.random(dst).astype(np.float32)
    mask = np.full(src, 255, np.uint8)
    mask[: src[0] // 5] = 0
    target = ((rng.random(src) > 0.7) * 255).astype(np.uint8)
    np.testing.assert_array_equal(density._fov_values(arr, mask),
                                  jax_density._fov_values(arr, mask))
    for m in (mask, None):
        np.testing.assert_array_equal(density._dilated_region(dst, target, inverse, m),
                                      jax_density._dilated_region(dst, target, inverse, m))


def test_report_writes_jax_file_set(reports):
    assert _files(reports["port"]) == _files(reports["jax"])
    assert len(_files(reports["port"])) == 39


@pytest.mark.parametrize("name", ["std_magnitudes_db.csv", "std_magnitudes_rot.csv"])
def test_magnitude_csvs_are_byte_equal(reports, name):
    with open(join(reports["jax"], name), "rb") as a, open(join(reports["port"], name), "rb") as b:
        assert b.read() == a.read()


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_all_metrics_csv_equals_jax_but_at_pandas_parser_ulps(reports):
    """all_metrics.csv is JAX's byte for byte but where pandas' read_csv
    parses a 17-digit float off its correctly rounded value (the tree's
    metrics.csv holds 0.12192005473212653, which pandas reads as
    0.1219200547321265, 2 ulps below): there the port keeps the source's
    text (asserted), and JAX's value is at most 2 ulps from it."""
    assert pd.read_csv(io.StringIO("x\n0.12192005473212653\n"))["x"][0] == 0.1219200547321265
    jax_rows = _rows(join(reports["jax"], "all_metrics.csv"))
    port_rows = _rows(join(reports["port"], "all_metrics.csv"))
    assert port_rows[0] == jax_rows[0] == [
        "Validation_Image", "F1_Vessel", "AUROC_Vessel", "Accuracy_Vessel", "name"]
    assert len(port_rows) == len(jax_rows) == 9
    source = {}
    for model in MODELS:
        for sub, name in (("statistics", model), ("dropblock_uncertainty/statistics",
                                                 f"{model}_DB")):
            rows = _rows(join(reports["runs"], model, sub, "val_images", "metrics.csv"))[1:]
            source[name] = rows
    ulps = 0
    for i, (prow, jrow) in enumerate(zip(port_rows[1:], jax_rows[1:])):
        assert prow[-1] == jrow[-1]
        assert prow[:-1] == source[prow[-1]][i % 2]  # the source's text, round-tripped
        for p, j in zip(prow, jrow):
            if p != j:
                assert 0 < abs(float(p) - float(j)) <= 2 * np.spacing(float(j)), (p, j)
                ulps += 1
    assert ulps == 2


def test_kde_curves_match_sklearn(reports):
    jax_calls, port_calls = reports["jax_kde"], reports["port_kde"]
    # std: BM-1 in two groups and LF-3 in two, for DB and ROT, and 2 x 2 x 2
    # single-image curves; cv: the group curves again; did: 2 x 2
    assert len(port_calls) == len(jax_calls) == 8 + 8 + 8 + 4
    for (jargs, (jxs, jdens)), (pargs, (pxs, pdens)) in zip(jax_calls, port_calls):
        np.testing.assert_array_equal(pargs[0], jargs[0])
        assert pargs[1:3] == jargs[1:3] and pargs[3] == torch.device("cpu")
        np.testing.assert_array_equal(pxs, jxs)
        assert np.abs(pdens - jdens).max() <= 1e-9 * jdens.max()


def test_kde_blocks_match_the_dense_sum(monkeypatch):
    """Blocks of a few values and uploads smaller than the data give the
    dense float64 formula."""
    rng = np.random.default_rng(3)
    data = np.concatenate([rng.random(3000) * 0.5, rng.random(500) * 0.01]).astype(np.float32)
    monkeypatch.setattr(density, "_KDE_BLOCK", 7 * 250)
    monkeypatch.setattr(density, "_KDE_UPLOAD", 1000)
    xs, dens = density._kde_curve(data, (0, 0.5), 250, "cpu")
    h = 0.5 / 250
    d = xs[:, None] - data.astype(np.float64)[None, :]
    want = np.exp(-0.5 * d * d / (h * h)).sum(1) / (data.size * h * np.sqrt(2 * np.pi))
    assert np.abs(dens - want).max() <= 1e-12 * want.max()


def test_histograms_match_numpy_on_jax_selection(reports):
    jax_calls, port_calls = reports["jax_hist"], reports["port_hist"]
    assert len(port_calls) == len(jax_calls) == 2 * 5
    for (jargs, _), (pargs, (counts, edges)) in zip(jax_calls, port_calls):
        data, rnge = jargs[0], jargs[1]
        np.testing.assert_array_equal(pargs[0], data)
        want_counts, want_edges = np.histogram(data, bins="auto", range=rnge, density=True)
        np.testing.assert_array_equal(counts, want_counts)
        np.testing.assert_array_equal(edges, want_edges)


def test_report_from_memory_equals_the_cli(reports, tmp_path):
    """render_density_report on load_matrix_tensors' dict writes the files
    create_density writes, and the same CSVs."""
    data = density.load_matrix_tensors(reports["runs"], list(MODELS))
    masks = {i: np.asarray(Image.open(join(reports["aug"], "val", "masks", f"{i}_mask.png")))
             for i in range(2)}
    targets = {i: np.asarray(Image.open(join(reports["aug"], "val", "targets",
                                             f"{i}_target.png"))) for i in range(2)}
    density.render_density_report(data, masks, targets, str(tmp_path), list(MODELS), KINDS,
                                  device="cpu")
    assert _files(str(tmp_path)) == _files(reports["port"])
    for name in ("std_magnitudes_db.csv", "all_metrics.csv"):
        with open(join(tmp_path, name)) as a, open(join(reports["port"], name)) as b:
            assert a.read() == b.read()


def test_figures_are_written_without_curves(tmp_path):
    """A group with no model's tensors still gets its (empty) figure, as in
    the JAX package."""
    density.std_density(["BM-2"], {}, 0.01, (0, 0.5), 1000, "Base Model DB STD", "STD",
                        "Density", str(tmp_path), device="cpu")
    with Image.open(join(tmp_path, "Base_Model_DB_STD.png")) as im:
        assert im.size == (1500, 1000) and np.asarray(im).min() == 255


def test_create_density_defaults_to_the_card(tmp_path):
    """Without -device cpu create_density needs the card: here it raises
    before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the KDE runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_density.main(["-results_root", str(tmp_path / "missing"),
                             "-save_path", str(tmp_path / "out")])
    assert not exists(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        density._kde_curve(np.zeros(4, np.float32), (0, 1), 10)
