"""The port's evaluation layer (unet_research_tpu_torch/evaluation/) against
the JAX package's, which runs on sklearn, pandas and matplotlib.

Metrics to 1e-12 (float64 sums in another order); given the same predict
arrays, final_test_metrics writes a byte-equal metrics.csv and loss files,
.pt files that load equal, segmentation PNGs with equal pixels and the same
tree of files. The figures are drawn without matplotlib: the contour map's
colours are held within 1 uint8 level of matplotlib's 'seismic' under
imshow's min/max normalisation."""

import contextlib
import io
import os

import matplotlib

matplotlib.use("Agg")
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from matplotlib import cm  # noqa: E402
from matplotlib.colors import Normalize  # noqa: E402
from PIL import Image  # noqa: E402

from unet_research_tpu.evaluation import metrics as jax_metrics  # noqa: E402
from unet_research_tpu_torch.evaluation import artifacts, metrics  # noqa: E402


def _case(rng, h=24, w=20, levels=8):
    """seg with tied scores (multiples of 1/levels, 0.5 included), binary gt,
    a FOV mask whose 0.5 values truncate to 0 as the reference's .long()."""
    seg = (rng.integers(0, levels + 1, (h, w, 1)) / levels).astype(np.float32)
    gt = (rng.random((h, w, 1)) > 0.6).astype(np.float32)
    mask = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (h, w, 1), p=[0.2, 0.1, 0.7])
    return seg, gt, mask


@pytest.mark.parametrize("kind", ["ties", "ties_coarse", "continuous", "all_zero_pred",
                                  "all_one_pred"])
def test_accuracy_metrics_match_sklearn(rng, kind):
    seg, gt, mask = _case(rng, levels=2 if kind == "ties_coarse" else 8)
    if kind == "continuous":
        seg = rng.random(seg.shape).astype(np.float32)
    elif kind == "all_zero_pred":
        seg = np.zeros_like(seg)
    elif kind == "all_one_pred":
        seg = np.ones_like(seg)
    ref = jax_metrics.get_accuracy_metrics(seg, gt, mask)
    got = metrics.get_accuracy_metrics(seg, gt, mask)
    assert all(type(v) is float for v in got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float64), rtol=0, atol=1e-12)
    assert metrics.dice_score(seg, gt, mask) == pytest.approx(
        jax_metrics.dice_score(seg, gt, mask), abs=1e-12)


@pytest.mark.parametrize("fov_class", [0.0, 1.0])
def test_one_class_fov(rng, fov_class):
    """AUROC is undefined: the installed sklearn warns and gives NaN, and so
    does the port; F1 and accuracy are still equal."""
    seg, gt, mask = _case(rng)
    gt[mask.astype(np.int64) != 0] = fov_class
    with pytest.warns(UserWarning, match="Only one class"):
        ref = jax_metrics.get_accuracy_metrics(seg, gt, mask)
    with pytest.warns(UserWarning, match="Only one class"):
        got = metrics.get_accuracy_metrics(seg, gt, mask)
    assert np.isnan(ref[1]) and np.isnan(got[1])
    np.testing.assert_allclose([got[0], got[2]], [ref[0], ref[2]], rtol=0, atol=1e-12)


def _files(root):
    out = set()
    for base, dirs, files in os.walk(root):
        rel = os.path.relpath(base, root)
        out |= {os.path.normpath(os.path.join(rel, n)) + "/" for n in dirs}
        out |= {os.path.normpath(os.path.join(rel, n)) for n in files}
    return out


@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    """final_test_metrics of both packages on the same predict arrays, with
    and without the test split; the printed lines of each."""
    rng = np.random.default_rng(7)
    val, test = [], []
    for i in range(3):
        seg, gt, mask = _case(rng, 30, 26)
        seg = np.where(rng.random(seg.shape) < 0.5, seg, rng.random(seg.shape)).astype(np.float32)
        im = rng.random(seg.shape).astype(np.float32)
        val.append((i, seg[None], im[None], gt[None], mask[None]))
        if i < 2:
            test.append((i, seg[None] * 0.9, im[None], np.zeros_like(gt[None]), mask[None]))
    history = {"train_loss_epoch": [0.7, 0.1 + 0.2, 1 / 3, float("nan")],
               "val_loss_epoch": [0.65, 0.4, 1e-5, 0.25]}
    root = tmp_path_factory.mktemp("harness")
    runs = {}
    for disable_test in (False, True):
        for name, fn in (("jax", jax_metrics.final_test_metrics),
                         ("port", metrics.final_test_metrics)):
            out = root / f"{name}_{disable_test}"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result = fn(lambda ds: iter(ds), val, test, str(out), history,
                            disable_test=disable_test)
            runs[name, disable_test] = (out, result, buf.getvalue())
    return val, runs


@pytest.mark.parametrize("disable_test", [False, True])
def test_final_test_metrics_writes_what_jax_writes(harness_runs, disable_test):
    val, runs = harness_runs
    (jout, jdf, jprint), (pout, scores, pprint) = runs["jax", disable_test], runs["port", disable_test]
    assert pprint == jprint
    assert _files(pout) == _files(jout)
    assert sorted(f for f in _files(pout) if not f.endswith("/")) == metrics.output_files(
        len(val), 0 if disable_test else 2, disable_test)
    for rel in ("val_images/metrics.csv", "losses/train_losses.txt",
                "losses/validation_losses.txt"):
        assert (pout / rel).read_bytes() == (jout / rel).read_bytes(), rel
    assert list(scores) == list(jdf.columns)
    for col in scores:
        assert scores[col] == jdf[col].tolist()
    for i in range(len(val)):
        rel = f"val_images/tensors/image_{i}/segmentation.pt"
        a, b = torch.load(pout / rel), torch.load(jout / rel)
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    if not disable_test:
        for i in (1, 2):
            rel = f"test_images/segmentations/{i}.png"
            with Image.open(pout / rel) as a, Image.open(jout / rel) as b:
                assert a.mode == b.mode == "L"
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_contour_map_is_matplotlib_seismic(harness_runs):
    val, runs = harness_runs
    out = runs["port", False][0]
    for i, seg, _, gt, _ in val:
        s, g = np.round(seg[0, ..., 0]), gt[0, ..., 0]
        diff = 2 * (s - g) / np.clip(np.abs(s) + np.abs(g), 1e-6, None)
        ref = cm.seismic(Normalize(diff.min(), diff.max())(diff), bytes=True)[..., :3]
        with Image.open(out / f"val_images/examples/val_image_{i + 1}/contour_map.png") as im:
            got = np.asarray(im.convert("RGB")).astype(np.int16)
        assert got.shape == ref.shape
        assert np.abs(got - ref.astype(np.int16)).max() <= 1


def test_figure_panels(harness_runs, tmp_path):
    """val_example: image | seg | thresholded seg | gt; overlap: 0.9 red over
    the gray gt where the thresholded seg is set."""
    val, _ = harness_runs
    _, seg, im, gt, _ = val[0]
    seg, im, gt = seg[0], im[0], gt[0]
    artifacts.save_val_example(im, seg, gt, 1, str(tmp_path))
    artifacts.save_overlap_map(seg, gt, str(tmp_path))
    h, w = seg.shape[:2]
    g = 4  # the gutter
    with Image.open(tmp_path / "val_example_1.png") as fig:
        panels = np.asarray(fig)
    assert panels.shape == (h, 4 * w + 3 * g)
    expect = [im, seg, np.round(seg), gt]
    for k, arr in enumerate(expect):
        np.testing.assert_array_equal(panels[:, k * (w + g):k * (w + g) + w],
                                      np.clip(np.round(arr[..., 0] * 255), 0, 255))
    with Image.open(tmp_path / "overlap_map.png") as fig:
        over = np.asarray(fig).astype(np.float64)
    gray = np.round(gt[..., 0] * 255)
    hit = np.round(seg[..., 0]) != 0
    np.testing.assert_array_equal(over[..., 0], np.where(hit, np.rint(229.5 + 0.1 * gray), gray))
    np.testing.assert_array_equal(over[..., 1], np.where(hit, np.rint(0.1 * gray), gray))


def test_loss_profile_draws_both_series(tmp_path):
    artifacts.save_loss_profile([0.9, 0.5, 0.3], [0.8, 0.6, 0.55], str(tmp_path))
    with Image.open(tmp_path / "loss_profile.png") as fig:
        img = np.asarray(fig)
    blue = (img == (0, 0, 255)).all(-1).sum()
    red = (img == (255, 0, 0)).all(-1).sum()
    assert img.shape == (500, 800, 3) and blue > 100 and red >= 3 * 16
    artifacts.save_loss_profile([], [], str(tmp_path))
    with Image.open(tmp_path / "loss_profile.png") as fig:
        assert (np.asarray(fig) == 255).all()
