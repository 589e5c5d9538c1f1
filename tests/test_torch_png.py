"""The port's PNG reader and writer (unet_research_tpu_torch/utils/png.py)
against PIL, and its split reader (data/dataset.py::load_split) against the
JAX package's. Exact throughout: equal uint8 pixels.

Files come from PIL's own encoder (adaptive row filters) and from an encoder
written here that applies a chosen filter to each row, so that every filter
type is read at every size, including a 1x1 image."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from unet_research_tpu.data.dataset import load_split as jax_load_split
from unet_research_tpu_torch.data.dataset import load_split
from unet_research_tpu_torch.utils.png import read_png, write_png

SIZES = [(1, 1), (7, 13), (584, 565)]
# PIL mode -> (PNG colour type, bit depth, samples per pixel)
MODES = {"1": (0, 1, 1), "L": (0, 8, 1), "LA": (4, 8, 2), "P": (3, 8, 1), "RGB": (2, 8, 3),
         "RGBA": (6, 8, 4)}
# 'pil': PIL's encoder; 'rows+k': row r filtered with type (r + k) % 5
FILTERS = ["pil"] + [f"rows+{k}" for k in range(5)]


def _pil_image(mode, h, w, rng):
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool))
    if mode == "P":
        im = Image.frombytes("P", (w, h), rng.integers(0, 256, (h, w), dtype=np.uint8).tobytes())
        im.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
        return im
    ch = MODES[mode][2]
    return Image.frombytes(mode, (w, h), rng.integers(0, 256, (h, w, ch), dtype=np.uint8).tobytes())


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _encode(im, first_filter, interlace=0):
    """PNG bytes of `im`, row r filtered with type (r + first_filter) % 5."""
    ctype, depth, ch = MODES[im.mode]
    w, h = im.size
    x = np.frombuffer(im.tobytes(), np.uint8).reshape(h, -1).astype(np.int16)
    bpp = max(1, ch * depth // 8)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth])
    kinds = (np.arange(h) + first_filter) % 5
    rows = (x - preds[kinds, np.arange(h)]) % 256
    raw = np.concatenate([kinds[:, None], rows], axis=1).astype(np.uint8)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if im.mode == "P":
        body += _chunk(b"PLTE", bytes(im.getpalette()[:768]))
    body += _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b"")
    return b"\x89PNG\r\n\x1a\n" + body


@pytest.mark.parametrize("filters", FILTERS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_equals_pil(tmp_path, mode, size, filters):
    rng = np.random.default_rng(zlib.crc32(repr((mode, size, filters)).encode()))
    im = _pil_image(mode, *size, rng)
    path = tmp_path / "x.png"
    if filters == "pil":
        im.save(path)
    else:
        path.write_bytes(_encode(im, int(filters[-1])))
    ref = np.asarray(Image.open(path).convert("L"))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == size
    np.testing.assert_array_equal(got, ref)


def test_pillow_luma_formula():
    """The formula the reader uses is Pillow's RGB -> L, checked against the
    installed Pillow on a grid of 256 x 52 x 37 colours."""
    v = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(v, v[::5], v[::7], indexing="ij"), -1).reshape(1, -1, 3)
    ref = np.asarray(Image.fromarray(grid, "RGB").convert("L")).astype(np.uint32)
    c = grid.astype(np.uint32)
    np.testing.assert_array_equal(
        ref, (c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16)


@pytest.mark.parametrize("colors", [2, 4, 16])
def test_small_palettes(tmp_path, colors):
    """PIL writes a palette of at most 16 colours at 1, 2 or 4 bits."""
    rng = np.random.default_rng(colors)
    im = Image.frombytes("P", (13, 7), rng.integers(0, colors, (7, 13), dtype=np.uint8).tobytes())
    im.putpalette(rng.integers(0, 256, 3 * colors, dtype=np.uint8).tolist())
    im.save(tmp_path / "p.png")
    assert (tmp_path / "p.png").read_bytes()[24] == {2: 1, 4: 2, 16: 4}[colors]  # IHDR depth
    np.testing.assert_array_equal(read_png(tmp_path / "p.png"),
                                  np.asarray(Image.open(tmp_path / "p.png").convert("L")))


def test_unsupported_files_raise_with_their_name(tmp_path):
    sixteen = tmp_path / "sixteen.png"
    Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000).save(sixteen)
    interlaced = tmp_path / "interlaced.png"
    interlaced.write_bytes(_encode(_pil_image("L", 4, 5, np.random.default_rng(0)), 0, interlace=1))
    for path, what in ((sixteen, "bit depth 16"), (interlaced, "interlaced")):
        with pytest.raises(ValueError, match=what) as err:
            read_png(path)
        assert path.name in str(err.value)
    bad = tmp_path / "bad.png"
    data = bytearray(_encode(_pil_image("L", 4, 5, np.random.default_rng(0)), 0))
    data[20] ^= 1  # inside IHDR: its CRC no longer holds
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad.png"):
        read_png(bad)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3])
def test_pil_reads_write_png(tmp_path, size, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size + ((3,) if channels == 3 else ()), dtype=np.uint8)
    write_png(tmp_path / "w.png", img)
    with Image.open(tmp_path / "w.png") as im:
        assert im.mode == ("RGB" if channels == 3 else "L")
        np.testing.assert_array_equal(np.asarray(im), img)
    if channels == 1:
        np.testing.assert_array_equal(read_png(tmp_path / "w.png"), img)


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
    return root


@pytest.mark.parametrize("split,with_targets", [("train", True), ("val", True), ("test", True),
                                                ("val", False)])
def test_load_split_equals_jax(tmp_path, split, with_targets):
    root = _aug_tree(tmp_path)
    if split == "val":  # a split without masks/: all 255 in both
        for f in (root / "val" / "masks").iterdir():
            f.unlink()
        (root / "val" / "masks").rmdir()
    ref = jax_load_split(str(root / split), with_targets=with_targets)
    got = load_split(str(root / split), with_targets=with_targets)
    for name in ("images", "targets", "masks"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
