"""The port's tensor viewer (unet_research_tpu_torch/cli/view_tensors.py)
against the JAX package's, on the fake run of tests/test_view_tensors.py
(BM-1 with DB and ROT tensors, LF-1 with DB only, 24x20) and on a run whose
tensors are at a resize (16x16, under 24x20 images).

The viewer writes JAX's file names, picks the same worst image with the
same MSE (1e-6), and its CV map equals JAX's; `_resize_to` is within 2e-5
of JAX's (PIL's float32 bilinear resize, 0-255 values); each panel is
matplotlib's colour table at the tensor's resolution."""

import contextlib
import io
import os
import re
from os.path import join

import numpy as np
import pytest
from PIL import Image

from unet_research_tpu.cli import view_tensors as jax_view
from unet_research_tpu_torch.cli import view_tensors
from unet_research_tpu_torch.evaluation import artifacts
from unet_research_tpu_torch.evaluation.raster import colorize


def _fake_run(root, model, rng, h=24, w=20, n_images=2, with_rot=True, dep=False):
    """tests/test_view_tensors.py:111-126, with an optional dependent run."""
    for i in range(n_images):
        db = join(root, model, "dropblock_uncertainty", "tensors", f"image_{i}")
        os.makedirs(db)
        mean = rng.random((1, h, w, 1), dtype=np.float32)
        std = rng.random((1, h, w, 1), dtype=np.float32) * 0.1
        artifacts.save_tensor_batched(mean, join(db, "mean.pt"))
        artifacts.save_tensor_batched(std, join(db, "std.pt"))
        if dep:
            d = join(root, model, "dropblock_uncertainty_dep", "tensors", f"image_{i}")
            os.makedirs(d)
            artifacts.save_tensor_batched(mean * 0.8, join(d, "mean.pt"))
        if with_rot:
            rot = join(root, model, "rotation_uncertainty", f"image_{i}")
            os.makedirs(rot)
            artifacts.save_tensor_batched(mean * 0.9, join(rot, "mean.pt"))
            artifacts.save_tensor_batched(std * 0.5, join(rot, "std.pt"))
        seg = join(root, model, "test_statistics", "val_images", "tensors", f"image_{i}")
        os.makedirs(seg)
        artifacts.save_tensor(rng.random((h, w, 1), dtype=np.float32), join(seg, "segmentation.pt"))


def _fake_aug(root, rng, h=24, w=20, n_images=2):
    """tests/test_view_tensors.py:129-139, with a disc FOV."""
    yy, xx = np.mgrid[:h, :w]
    disc = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2 < 1) * 255
    for sub in ("images", "targets", "masks"):
        d = join(root, "val", sub)
        os.makedirs(d)
        for i in range(n_images):
            arr = (rng.random((h, w)) * 255).astype(np.uint8)
            if sub == "masks":
                arr = disc.astype(np.uint8)
            Image.fromarray(arr, "L").save(join(d, f"{i}_{sub[:-1]}.png"))


def _jax_worst(models, results_root, val_data):
    """JAX's worst-image choice (view_tensors.py:159-176), from its own
    helpers."""
    base = next(m for m in models if jax_view._load_plain_segs(results_root, m))
    cur_i, real_max = None, -1.0
    for i, seg in jax_view._load_plain_segs(results_root, base).items():
        gt = jax_view._resize_to(val_data["targets"][i], seg.shape) / 255.0
        mse = float(np.mean((seg - gt) ** 2))
        if mse > real_max:
            cur_i, real_max = i, mse
    return base, cur_i, real_max


@pytest.fixture(scope="module", params=[(24, 20), (16, 16)], ids=["native", "resized"])
def viewers(request, tmp_path_factory):
    h, w = request.param
    root = tmp_path_factory.mktemp("viewer")
    rng = np.random.default_rng(0)
    results, aug = str(root / "runs"), str(root / "aug")
    _fake_run(results, "BM-1", rng, h, w, dep=True)
    _fake_run(results, "LF-1", rng, h, w, with_rot=False)
    _fake_aug(aug, rng)
    argv = ["-results_root", results, "-aug_root", aug, "-models", "BM-1,LF-1"]
    ref = jax_view.main(argv + ["-save_path", str(root / "jax")])
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = view_tensors.main(argv + ["-save_path", str(root / "port")])
    return {"jax": ref, "port": out, "results": results, "aug": aug, "log": log.getvalue(),
            "hw": (h, w)}


def test_viewer_writes_jax_files(viewers):
    assert sorted(os.listdir(viewers["port"])) == sorted(os.listdir(viewers["jax"])) == [
        "BM-1_image_0.png", "BM-1_image_1.png", "LF-1_image_0.png", "LF-1_image_1.png",
        "MSE_Plot_BM-1.png", "MSE_Plot_LF-1.png"]
    assert "rendered 6 panels" in viewers["log"]


def test_worst_image_matches_jax(viewers):
    val = jax_view._load_val_images(viewers["aug"])
    base, cur_i, real_max = _jax_worst(["BM-1", "LF-1"], viewers["results"], val)
    got = re.search(r"worst image for (\S+): (\d+) mse (\S+)", viewers["log"])
    assert got.group(1) == base and int(got.group(2)) == cur_i
    assert abs(float(got.group(3)) - real_max) <= 1e-6


def test_contact_sheet_panels(viewers):
    """BM-1's sheet: input, DB mean/std/CV, ROT mean/std/CV, the
    independent - dependent difference and GT, each matplotlib's colours at
    the tensor's resolution, side by side."""
    from unet_research_tpu_torch.evaluation.density import extract_tensors

    h, w = viewers["hw"]
    with Image.open(join(viewers["port"], "BM-1_image_0.png")) as im:
        sheet = np.asarray(im.convert("RGB"))
    assert sheet.shape == (24, 20 + 4 + 7 * (w + 4) + 20, 3)
    mean = extract_tensors(join(viewers["results"], "BM-1", "dropblock_uncertainty", "tensors"),
                           "mean.pt")[0][0, 0]
    x0 = 20 + 4  # after the 24x20 input panel and a gutter
    np.testing.assert_array_equal(sheet[:h, x0:x0 + w], colorize(mean, "gray", 0, 1))
    assert (sheet[h:, x0:x0 + w] == 255).all()  # a shorter panel stands on white


def test_cv_map_matches_jax():
    rng = np.random.default_rng(3)
    mean = rng.random((24, 20)).astype(np.float32)
    mean[0, :3] = 0.0
    std = (rng.random((24, 20)) * 0.1).astype(np.float32)
    std[0, 0] = 0.0
    for fov in (None, (rng.random((24, 20)) > 0.3).astype(np.float32)):
        np.testing.assert_array_equal(view_tensors._cv_map(mean, std, fov),
                                      jax_view._cv_map(mean, std, fov))


@pytest.mark.parametrize("src,dst", [((24, 20), (16, 16)), ((584, 565), (256, 256)),
                                     ((584, 565), (128, 128)), ((256, 256), (584, 565))])
def test_resize_to_matches_jax(src, dst):
    a = np.random.default_rng(1).integers(0, 256, src).astype(np.uint8)
    got = view_tensors._resize_to(a, dst)
    want = jax_view._resize_to(a, dst)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-5
    np.testing.assert_array_equal(view_tensors._resize_to(a, src), jax_view._resize_to(a, src))
