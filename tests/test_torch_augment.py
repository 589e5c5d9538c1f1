"""The port's data layer for dataset generation against the JAX package:
ops/image.py's cv2-style rotations, flips and gray conversion, the DRIVE
reader, the augmentation generator (data/augment.py) and both
create_augmentations CLIs, and batch_iterator's drop_last and prefetch.
Small seeded inputs; the DRIVE tree is the synthetic one of
tests/test_augment.py:67-86, built here.

Tolerances and the tie rule:
- bilinear floats within 0.05 on the 0-255 scale (float32 sin/cos of one
  angle may differ by an ulp between XLA and torch);
- nearest outputs equal except at pixels whose source coordinate, computed
  in float64 from the float32 radians both packages use, lies within 1e-4
  of a .5 tie (floor(src + 0.5) may fetch either neighbour there);
- uint8 files equal except at those nearest ties and, for the gray image,
  at pixels whose JAX float lies within 0.05 of a .5 rounding boundary;
  each test proves every differing pixel is such a tie and prints the
  counts;
- flips, the gray conversion, load_drive, the plans, the file lists, the
  train/val split and the batches exactly equal."""

import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unet_research_tpu.cli import create_augmentations as jax_cli
from unet_research_tpu.data import augment as jaug
from unet_research_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from unet_research_tpu.data.drive import load_drive as jax_load_drive
from unet_research_tpu.data.loading import batch_iterator as jax_batch_iterator
from unet_research_tpu.ops import image as jimage
from unet_research_tpu.utils.general import seed_everything as jax_seed_everything
from unet_research_tpu_torch.cli import create_augmentations as port_cli
from unet_research_tpu_torch.data import augment as taug
from unet_research_tpu_torch.data import ArrayDataset, batch_iterator, load_drive
from unet_research_tpu_torch.data.drive import read_image
from unet_research_tpu_torch.ops import image as timage

CPU = torch.device("cpu")
ANGLES = np.array([0.0, 90.0, -90.0, 180.0, 15.0, -97.3, 33.33, 179.9, -0.4], np.float32)


def _fake_drive(root):
    """The synthetic DRIVE tree of tests/test_augment.py:67-86."""
    rng = np.random.default_rng(0)
    for split, n, with_manual in [("training", 5, True), ("test", 3, False)]:
        d = root / split
        (d / "images").mkdir(parents=True)
        (d / "mask").mkdir()
        if with_manual:
            (d / "1st_manual").mkdir()
        for i in range(n):
            im = rng.integers(0, 256, (24, 20, 3)).astype(np.uint8)
            Image.fromarray(im).save(d / "images" / f"{21 + i}_{split}.tif")
            mask = (rng.random((24, 20)) > 0.3).astype(np.uint8) * 255
            Image.fromarray(mask).save(d / "mask" / f"{21 + i}_mask.gif")
            if with_manual:
                man = (rng.random((24, 20)) > 0.7).astype(np.uint8) * 255
                Image.fromarray(man).save(d / "1st_manual" / f"{21 + i}_manual1.gif")
    return str(root)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return _fake_drive(tmp_path_factory.mktemp("drive"))


# --- the tie rule ------------------------------------------------------------

def _nearest_ties(angles, rot_on, h: int, w: int) -> np.ndarray:
    """(K, H, W) True where the source coordinate of a cv2-style rotation
    (about (W/2, H/2)) lies within 1e-4 of a .5 tie, in float64 from the
    float32 radians."""
    a = np.where(rot_on, angles, np.float32(0)).astype(np.float32) * np.float32(np.pi / 180)
    a = a.astype(np.float64)[:, None, None]
    yy = np.arange(h, dtype=np.float64)[:, None] - h / 2
    xx = np.arange(w, dtype=np.float64)[None, :] - w / 2
    src_x = np.cos(a) * xx - np.sin(a) * yy + w / 2
    src_y = np.sin(a) * xx + np.cos(a) * yy + h / 2

    def near(s):
        return np.abs(s - np.floor(s) - 0.5) < 1e-4

    return near(src_x) | near(src_y)


def _rounding_ties(ref: np.ndarray) -> np.ndarray:
    """True where a float lies within 0.05 of a .5 rounding boundary."""
    return np.abs(ref - np.floor(ref) - 0.5) <= 0.05


def _assert_equal_but_ties(got, want, ties, what: str) -> int:
    """got == want except where `ties` (broadcast over channels) is True;
    prints and returns the number of tie pixels that differ."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ties = np.broadcast_to(ties.reshape(ties.shape + (1,) * (got.ndim - ties.ndim)), got.shape)
    differ = got != want
    assert not (differ & ~ties).any(), f"{what}: {int((differ & ~ties).sum())} differ off the ties"
    n = int(differ.sum())
    print(f"{what}: {int(ties.sum())} tie pixels, {n} of them differ")
    return n


def _u8(a):
    return np.clip(np.round(np.asarray(a)), 0, 255).astype(np.uint8)


# --- image ops -----------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_rotate_cv2_like_matches_jax(interpolation, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (1, 41, 37, channels)).astype(np.float32)
    if interpolation == "nearest":
        img = (img > 127).astype(np.float32) * 255
    got = timage.rotate_cv2_like(torch.from_numpy(img), torch.from_numpy(ANGLES),
                                 interpolation, "replicate").numpy()
    want = np.stack([np.asarray(jimage.rotate_cv2_like(jnp.asarray(img), float(a), interpolation,
                                                       "replicate"))[0] for a in ANGLES])
    if interpolation == "bilinear":
        np.testing.assert_allclose(got, want, atol=0.05, rtol=0)
        ties = _rounding_ties(want)
        _assert_equal_but_ties(_u8(got), _u8(want), ties, "bilinear uint8")
    else:
        ties = _nearest_ties(ANGLES, np.ones(len(ANGLES), bool), 41, 37)
        _assert_equal_but_ties(got, want, ties, "nearest")
    # angle 0 returns the input exactly
    np.testing.assert_array_equal(got[0], img[0])


def test_rotate_cv2_like_zeros_border_and_sources():
    """border='zeros' as JAX's, and `source` picks each member's image
    (values in 0..1: within 2e-4, the 0.05 of the 0-255 scale)."""
    rng = np.random.default_rng(2)
    img = rng.random((3, 20, 17, 2)).astype(np.float32)
    src = np.array([2, 0, 1, 2])
    got = timage.rotate_cv2_like(torch.from_numpy(img), torch.tensor([10.0, -50.0, 77.0, 130.0]),
                                 "bilinear", "zeros", source=torch.from_numpy(src)).numpy()
    for k, (s, a) in enumerate(zip(src, (10.0, -50.0, 77.0, 130.0))):
        want = np.asarray(jimage.rotate_cv2_like(jnp.asarray(img[s:s + 1]), a, "bilinear", "zeros"))
        np.testing.assert_allclose(got[k], want[0], atol=2e-4, rtol=0)


def _rotate_bilinear_zero_fill(img, angles):
    """rotate_bilinear as written before the gathers took a border and a
    source (zero fill only)."""
    n, h, w, c = img.shape
    a = (torch.as_tensor(angles, dtype=torch.float32) * np.float32(np.pi / 180))[:, None, None]
    k = a.shape[0]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32)[None, :] - cx
    src_x = torch.cos(a) * xx - torch.sin(a) * yy + cx
    src_y = torch.sin(a) * xx + torch.cos(a) * yy + cy
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0)[..., None], (src_x - x0)[..., None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    flat = img.reshape(n, h * w, c)
    member = (torch.arange(k) if n == k else torch.zeros(k, dtype=torch.int64))[:, None]

    def tap(yi, xi):
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat[member, idx.reshape(k, -1)].reshape(k, h, w, c)
        return vals * ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None].to(img.dtype)

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


@pytest.mark.parametrize("batched", [False, True])
def test_rotate_bilinear_keeps_its_numbers(batched):
    """Bit for bit what it computed before the border and source options."""
    rng = np.random.default_rng(5)
    angles = torch.tensor([0.0, 45.0, 90.0, 135.0, 200.5, 359.0])
    img = torch.from_numpy(rng.random((6 if batched else 1, 23, 30, 2)).astype(np.float32))
    assert torch.equal(timage.rotate_bilinear(img, angles), _rotate_bilinear_zero_fill(img, angles))


@pytest.mark.parametrize("code", [-1, 0, 1])
def test_flip_and_gray_match_jax(code):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (2, 9, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.flip_nhwc(torch.from_numpy(img), code).numpy(),
                                  np.asarray(jimage.flip_nhwc(jnp.asarray(img), code)))
    np.testing.assert_array_equal(timage.to_gray_rgb(torch.from_numpy(img)).numpy(),
                                  np.asarray(jimage.to_gray_rgb(jnp.asarray(img))))
    with pytest.raises(ValueError, match="flip code"):
        timage.flip_nhwc(torch.from_numpy(img), 2)


# --- the DRIVE reader ------------------------------------------------------------

def test_load_drive_matches_jax(drive):
    for split in ("training", "test"):
        got, want = load_drive(drive, split), jax_load_drive(drive, split)
        assert len(got) == len(want)
        for a, b in ((got.images, want.images), (got.targets, want.targets),
                     (got.masks, want.masks)):
            if b is None:
                assert a is None
            else:
                assert a.dtype == np.uint8
                np.testing.assert_array_equal(a, b)
    assert got.images.shape == (3, 24, 20, 3) and got.masks.shape == (3, 24, 20)


def test_read_image_rejects_other_files(tmp_path):
    path = tmp_path / "x.png"
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(path)
    with pytest.raises(ValueError, match="neither a TIFF nor a GIF"):
        read_image(str(path), "L")


# --- the generator ------------------------------------------------------------

def _jax_batch(im, gt, mask, plan):
    out = jaug._augment_batch(jnp.asarray(im, jnp.float32), jnp.asarray(gt, jnp.float32)[..., None],
                              jnp.asarray(mask, jnp.float32)[..., None],
                              *(jnp.asarray(p) for p in plan), num=len(plan[0]))
    return [np.asarray(t) for t in jax.device_get(out)]


def _port_batch(im, gt, mask, plan):
    out = taug._augment_batch(*taug._on_device(im, gt, mask, CPU), *plan)
    return [t.numpy() for t in out]


def test_plan_matches_jax():
    got = taug._plan(np.random.default_rng(9), 40)
    want = jaug._plan(np.random.default_rng(9), 40)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_augment_batch_matches_jax():
    """One source image, 36 members: every flip, rotation on and off, the
    angles 0, +-90 and 180 (ties at every pixel of an odd width) and
    non-integer ones."""
    rng = np.random.default_rng(11)
    h, w = 64, 57
    im = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    gt = ((rng.random((h, w)) > 0.7) * 255).astype(np.uint8)
    mask = ((rng.random((h, w)) > 0.3) * 255).astype(np.uint8)
    angles, rot_on, flip_v, flip_h = taug._plan(np.random.default_rng(12), 36)
    angles[:len(ANGLES)] = ANGLES
    rot_on[:6] = [True, True, True, True, False, False]
    flip_v[:4], flip_h[:4] = [False, True, False, True], [False, False, True, True]
    plan = (angles, rot_on, flip_v, flip_h)
    got, want = _port_batch(im, gt, mask, plan), _jax_batch(im, gt, mask, plan)
    assert [g.shape for g in got] == [(36, h, w, 3), (36, h, w, 1), (36, h, w, 1)]
    np.testing.assert_allclose(got[0], want[0], atol=0.05, rtol=0)
    ties = _nearest_ties(angles, rot_on, h, w)
    assert ties[1].all() and ties[2].all()  # +-90 degrees at an odd width
    for name, g, wnt in zip(("target", "mask"), got[1:], want[1:]):
        _assert_equal_but_ties(g, wnt, ties, f"augment_batch {name}")
        _assert_equal_but_ties(_u8(g), _u8(wnt), ties, f"augment_batch {name} uint8")
    _assert_equal_but_ties(_u8(got[0]), _u8(want[0]), _rounding_ties(want[0]),
                           "augment_batch image uint8")


def _read(path):
    with Image.open(path) as im:
        return np.asarray(im)


def _files(root):
    return sorted(os.path.relpath(join(b, f), root) for b, _, fs in os.walk(root) for f in fs)


def _assert_trees_equal_but_ties(got_root, want_root, floats, plans, what):
    """Every file of want_root exists in got_root and reads equal, except at
    ties: `floats` are the JAX float (image, target, mask) of each running
    index, `plans` its (angle, rot_on) (None for an identity plan)."""
    assert _files(got_root) == _files(want_root)
    for i, ((im, gt, mask), plan) in enumerate(zip(floats, plans)):
        h, w = gt.shape[:2]
        near = (np.zeros((h, w), bool) if plan is None
                else _nearest_ties(np.array([plan[0]]), np.array([plan[1]]), h, w)[0])
        for kind, suffix, ties in (("images", "image", _rounding_ties(im)),
                                   ("targets", "target", near), ("masks", "mask", near)):
            rel = join(kind, f"{i}_{suffix}.png")
            _assert_equal_but_ties(_read(join(got_root, rel)), _read(join(want_root, rel)),
                                   ties[..., 0] if ties.ndim == 3 else ties, f"{what} {rel}")


def _jax_givens_floats(items, seed: int, num: int, augment: bool):
    """The JAX float outputs and plans of gen_givens(items, seed, num), in
    file order, replayed with the JAX package's own functions."""
    rng = np.random.default_rng(seed)
    floats, plans = [], []
    for im, gt, mask in items:
        plan = jaug._plan(rng, num) if augment else None
        p = tuple(np.asarray(a) for a in plan) if augment else taug._identity_plan(num)
        outs = _jax_batch(im, gt, mask, p)
        for k in range(num):
            floats.append([o[k] for o in outs])
            plans.append((p[0][k], p[1][k]) if augment else None)
    return floats, plans


def test_gen_givens_and_gen_tests_match_jax(drive, tmp_path):
    given = jax_load_drive(drive, "training")
    items = [given[i] for i in range(3)]
    for augment, num in ((True, 4), (False, 1)):
        dests = tmp_path / f"jax{augment}", tmp_path / f"port{augment}"
        assert jaug.gen_givens(str(dests[0]), num, items, 5, augment) == len(items) * num
        assert taug.gen_givens(str(dests[1]), num, items, 5, augment, device="cpu") == len(items) * num
        floats, plans = _jax_givens_floats(items, 5, num, augment)
        _assert_trees_equal_but_ties(str(dests[1]), str(dests[0]), floats, plans, "gen_givens")
    test = jax_load_drive(drive, "test")
    items = [test[i] for i in range(len(test))]
    assert jaug.gen_tests(str(tmp_path / "jt"), items) == taug.gen_tests(
        str(tmp_path / "pt"), items, device="cpu") == 3
    assert _files(tmp_path / "pt") == _files(tmp_path / "jt")
    assert sorted(os.listdir(tmp_path / "pt" / "images"))[0] == "01_image.png"
    for rel in _files(tmp_path / "pt"):
        np.testing.assert_array_equal(_read(tmp_path / "pt" / rel), _read(tmp_path / "jt" / rel))


@pytest.mark.parametrize("resize_up", [False, True])
def test_gen_givens_resized_matches_jax(drive, tmp_path, resize_up):
    """Float differences pass through the resize, so the uint8 files may
    differ only where JAX's resized float lies within 0.05 of a .5
    boundary (no nearest tie falls on this plan: asserted)."""
    given = jax_load_drive(drive, "training")
    items = [given[i] for i in range(3)]
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    kw = dict(sizes=[-1, 12], num=[2, 3], items=items, seed=7, resize_up=resize_up)
    assert jaug.gen_givens_resized(str(tmp_path / "j"), **kw) == 5
    assert taug.gen_givens_resized(str(tmp_path / "p"), device="cpu", **kw) == 5
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    # replay the JAX floats: the size plan, then one plan per output
    plan = np.repeat(np.asarray([-1, 12]), np.asarray([2, 3]))
    np.random.default_rng(7).shuffle(plan)
    rng = np.random.default_rng(7)
    for i in range(5):
        im, gt, mask = items[i % 3]
        p = tuple(np.asarray(a) for a in jaug._plan(rng, 1))
        assert not _nearest_ties(p[0], p[1], 24, 20).any()
        triple = [t[0] for t in _jax_batch(im, gt, mask, p)]
        if plan[i] != -1:
            s = int(plan[i])
            triple = [np.asarray(jimage.resize_bilinear(jnp.asarray(t)[None], (s, s)))[0]
                      for t in triple]
            if resize_up:
                triple = [np.asarray(jimage.resize_bilinear(jnp.asarray(t)[None], (24, 20)))[0]
                          for t in triple]
        for kind, suffix, f in zip(("images", "targets", "masks"), ("image", "target", "mask"),
                                   triple):
            rel = join(kind, f"{i}_{suffix}.png")
            ties = _rounding_ties(f)
            _assert_equal_but_ties(_read(tmp_path / "p" / rel), _read(tmp_path / "j" / rel),
                                   ties[..., 0], f"resized {rel}")


def test_create_augmentations_clis_match_jax(drive, tmp_path):
    """Both CLIs on one DRIVE tree: the same files, the same train/val
    split, the arrays equal but at ties, and the port deterministic."""
    argv = ["-seed", "1234", "-data_root", drive, "-num_train", "4"]
    want = jax_cli.main(argv + ["-dest", str(tmp_path / "jax")])
    got = port_cli.main(argv + ["-dest", str(tmp_path / "port"), "-device", "cpu"])
    again = taug.create_augmentations(drive, str(tmp_path / "port"), 1234, 4, device="cpu")
    assert again == str(tmp_path / "port") + "1"  # the dest1..dest4 retry
    assert _files(got) == _files(want)
    assert len(os.listdir(join(got, "train", "images"))) == 12
    assert sorted(os.listdir(join(got, "test", "images"))) == [
        "01_image.png", "02_image.png", "03_image.png"]
    for rel in _files(got):  # deterministic from the seed, byte for byte
        with open(join(got, rel), "rb") as a, open(join(again, rel), "rb") as b:
            assert a.read() == b.read(), rel
    # the same split: val and test are gray copies, equal exactly
    for rel in _files(got):
        if not rel.startswith("train"):
            np.testing.assert_array_equal(_read(join(got, rel)), _read(join(want, rel)))
    # the train files, replayed from the JAX seed and permutation
    jax_seed_everything(1234)
    given = jax_load_drive(drive, "training")
    perm = np.random.permutation(len(given))
    items = [given[i] for i in perm[:int(len(given) * 0.7)]]
    floats, plans = _jax_givens_floats(items, 1234, 4, True)
    _assert_trees_equal_but_ties(join(got, "train"), join(want, "train"), floats, plans,
                                 "create_augmentations train")


# --- batch feeding ------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 1, 3])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_iterator_matches_jax(drop_last, prefetch):
    rng = np.random.default_rng(13)
    arrays = [rng.integers(0, 256, (7, 5, 4, 1)).astype(np.uint8) for _ in range(3)]
    for shuffle in (False, True):
        got = list(batch_iterator(ArrayDataset(*arrays), 3, shuffle, np.random.default_rng(2),
                                  drop_last=drop_last, device="cpu", prefetch=prefetch))
        want = list(jax_batch_iterator(JaxArrayDataset(*arrays), 3, shuffle,
                                       np.random.default_rng(2), drop_last=drop_last,
                                       prefetch=prefetch))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
