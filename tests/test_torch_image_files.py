"""The port's GIF and TIFF readers (utils/gif.py, utils/tiff.py) against
PIL, on files PIL writes and on files written here byte by byte (GIF LZW
streams with and without a clear code at a full table, TIFF in both byte
orders with several strips).

Tolerance: none. Every array equals `Image.open(path).convert(mode)` for
mode "L" and "RGB"; a file feature the readers lack raises ValueError
naming the file."""

import struct

import numpy as np
import pytest
from PIL import Image

from unet_research_tpu_torch.utils.gif import read_gif
from unet_research_tpu_torch.utils.tiff import read_tiff

SMALL, DRIVE = (24, 20), (584, 565)


def _assert_reads_as_pil(path, reader, modes=("L", "RGB")):
    for mode in modes:
        with Image.open(path) as im:
            want = np.asarray(im.convert(mode))
        got = reader(path, mode)
        assert got.dtype == np.uint8 and got.shape == want.shape, (mode, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{path} {mode}")


# --- GIF ---------------------------------------------------------------------

def _gif_source(kind: str, colours: int, shape, seed: int) -> Image.Image:
    """An L image of `colours` gray levels, or a P image with a random
    palette of `colours` entries."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, colours, shape).astype(np.uint8)
    if kind == "L":
        return Image.fromarray((idx * (255 // (colours - 1))).astype(np.uint8))
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, (colours, 3)).astype(np.uint8).tobytes())
    return im


GIF_CASES = ([(kind, c, il, SMALL) for kind in ("L", "P") for c in (2, 4, 16, 256)
              for il in (False, True)]
             + [("L", 2, False, DRIVE), ("P", 4, True, DRIVE), ("L", 256, False, DRIVE),
                ("P", 256, True, DRIVE)])


@pytest.mark.parametrize("kind,colours,interlace,shape", GIF_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_gif_written_by_pil(tmp_path, kind, colours, interlace, shape):
    path = tmp_path / "a.gif"
    _gif_source(kind, colours, shape, seed=colours).save(path, interlace=interlace)
    _assert_reads_as_pil(path, read_gif)


def _lzw_codes(data: bytes, literal_bits: int, table_full: str):
    """(code, width) of a greedy GIF LZW encoder. table_full: 'clear' sends
    a clear code when the table is full, 'defer' goes on at 12 bits with
    the full table (the deferred clear), 'literal254' sends only literals
    and a clear code every 254 of them, so the codes stay at 9 bits."""
    clear = 1 << literal_bits
    state = {"width": literal_bits + 1, "size": clear + 2, "first": True}
    codes = []

    def emit(code):  # with the width the decoder reads it at, then its update
        codes.append((code, state["width"]))
        if code == clear:
            state.update(width=literal_bits + 1, size=clear + 2, first=True)
        elif state["first"]:
            state["first"] = False
        elif state["size"] < 4096:
            state["size"] += 1
            if state["size"] == 1 << state["width"] and state["width"] < 12:
                state["width"] += 1

    emit(clear)
    if table_full == "literal254":
        for i, b in enumerate(data):
            if i and i % 254 == 0:
                emit(clear)
            emit(b)
    else:
        table = {bytes((i,)): i for i in range(clear)}
        nxt, w = clear + 2, b""
        for b in data:
            wc = w + bytes((b,))
            if wc in table:
                w = wc
                continue
            emit(table[w])
            if nxt < 4096:
                table[wc] = nxt
                nxt += 1
            elif table_full == "clear":
                emit(clear)
                table = {bytes((i,)): i for i in range(clear)}
                nxt = clear + 2
            w = bytes((b,))
        emit(table[w])
    emit(clear + 1)
    return codes


def _gif_file(idx: np.ndarray, palette: np.ndarray, literal_bits: int, table_full: str) -> bytes:
    h, w = idx.shape
    buf, nbits, out = 0, 0, bytearray()
    for code, width in _lzw_codes(idx.tobytes(), literal_bits, table_full):
        buf |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(buf & 255)
            buf >>= 8
            nbits -= 8
    if nbits:
        out.append(buf)
    bits = int(np.log2(len(palette))) - 1
    blocks = b"".join(bytes((len(out[i:i + 255]),)) + bytes(out[i:i + 255])
                      for i in range(0, len(out), 255))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0x80 | bits, 0, 0) + palette.tobytes()
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes((literal_bits,)) + blocks
            + b"\x00;")


@pytest.mark.parametrize("table_full", ["clear", "defer", "literal254"])
@pytest.mark.parametrize("literal_bits", [2, 5, 8])
def test_gif_lzw_streams(tmp_path, table_full, literal_bits):
    """A full-size image whose LZW table fills many times: the clear code at
    a full table, the deferred clear, and the 9-bit literal stream."""
    rng = np.random.default_rng(literal_bits)
    colours = 1 << literal_bits
    # runs and noise, so that the encoder meets KwKwK strings and a full table
    idx = np.repeat(rng.integers(0, colours, (DRIVE[0], DRIVE[1] // 5 + 1)), 5, axis=1)
    idx = idx[:, :DRIVE[1]].astype(np.uint8)
    idx[::7] = rng.integers(0, colours, (idx[::7].shape)).astype(np.uint8)
    palette = rng.integers(0, 256, (max(colours, 4), 3)).astype(np.uint8)
    path = tmp_path / "b.gif"
    path.write_bytes(_gif_file(idx, palette, literal_bits, table_full))
    with Image.open(path) as im:  # PIL agrees on the indices
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), palette[idx])
    _assert_reads_as_pil(path, read_gif)


def test_gif_features_that_raise(tmp_path):
    idx = np.zeros((8, 8), np.uint8)
    pal = np.zeros((4, 3), np.uint8)
    good = _gif_file(idx, pal, 2, "clear")
    cases = {
        "not a GIF file": b"GIF00a" + good[6:],
        "does not cover": good.replace(b"," + struct.pack("<HHHH", 0, 0, 8, 8),
                                       b"," + struct.pack("<HHHH", 1, 0, 7, 8)),
        "truncated": good[:good.index(b",") + 14],
        "minimum code size": good.replace(b"," + struct.pack("<HHHHB", 0, 0, 8, 8, 0) + b"\x02",
                                          b"," + struct.pack("<HHHHB", 0, 0, 8, 8, 0) + b"\x09"),
    }
    for match, data in cases.items():
        path = tmp_path / "bad.gif"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=match):
            read_gif(path)
        assert str(path) in str(pytest.raises(ValueError, read_gif, path).value)
    with pytest.raises(ValueError, match="mode"):
        read_gif(tmp_path / "bad.gif", "P")


# --- TIFF --------------------------------------------------------------------

TIFF_CASES = ([(m, c, SMALL) for m in ("RGB", "L") for c in ("raw", "tiff_lzw", "packbits",
                                                                "lzw_predictor")]
              + [("L", c, DRIVE) for c in ("raw", "tiff_lzw", "packbits", "lzw_predictor")]
              + [("RGB", "raw", DRIVE), ("RGB", "packbits", DRIVE), ("RGB", "tiff_lzw", DRIVE)])


@pytest.mark.parametrize("mode,compression,shape", TIFF_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_tiff_written_by_pil(tmp_path, mode, compression, shape):
    rng = np.random.default_rng(len(compression))
    arr = rng.integers(0, 256, shape + ((3,) if mode == "RGB" else ())).astype(np.uint8)
    # smooth rows as well as noise, so that LZW and PackBits both find runs
    arr[: shape[0] // 2] = arr[: shape[0] // 2, :1]
    path = tmp_path / "a.tif"
    strip = 5 * arr[0].size  # five rows a strip (the compressed writer takes it)
    if compression == "lzw_predictor":
        Image.fromarray(arr).save(path, compression="tiff_lzw", tiffinfo={317: 2},
                                  strip_size=strip)
    else:
        Image.fromarray(arr).save(path, compression=compression, strip_size=strip)
    with Image.open(path) as im:
        assert im.mode == mode and np.array_equal(np.asarray(im), arr)
        strips = len(im.tag_v2[273])
    assert strips > 1 or compression == "raw"
    # the larger RGB LZW file is read in one mode only (pure-Python LZW)
    modes = ("RGB",) if (mode, compression, shape) == ("RGB", "tiff_lzw", DRIVE) else ("L", "RGB")
    _assert_reads_as_pil(path, read_tiff, modes)


def _raw_tiff(arr: np.ndarray, order: str, rows_per_strip: int, extra=()) -> bytes:
    """An uncompressed TIFF of uint8 (H, W) or (H, W, 3), in byte order
    '<' (II) or '>' (MM), with `extra` (tag, type, values) entries."""
    h, w = arr.shape[:2]
    spp = 1 if arr.ndim == 2 else 3
    strips = [arr[i:i + rows_per_strip].tobytes() for i in range(0, h, rows_per_strip)]
    n = len(strips)
    entries = [(256, 3, [w]), (257, 3, [h]), (258, 3, [8] * spp), (259, 3, [1]),
               (262, 3, [1 if spp == 1 else 2]), (273, 4, [0] * n), (277, 3, [spp]),
               (278, 3, [rows_per_strip]), (279, 4, [len(s) for s in strips]),
               (284, 3, [1])]
    entries = sorted({e[0]: e for e in entries + list(extra)}.values())
    size = {3: 2, 4: 4}
    ifd_end = 8 + 2 + 12 * len(entries) + 4
    spill = [e for e in entries if len(e[2]) * size[e[1]] > 4]
    data_at = ifd_end + sum(len(e[2]) * size[e[1]] for e in spill)
    offsets = np.cumsum([data_at] + [len(s) for s in strips[:-1]]).tolist()
    entries = [(t, k, offsets if t == 273 else v) for t, k, v in entries]
    out, tail = bytearray(), bytearray()
    out += (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", 8)
    out += struct.pack(order + "H", len(entries))
    for tag, kind, values in entries:
        packed = struct.pack(f"{order}{len(values)}{'H' if kind == 3 else 'I'}", *values)
        if len(packed) > 4:
            field = struct.pack(order + "I", ifd_end + len(tail))
            tail += packed
        else:
            field = packed.ljust(4, b"\x00")
        out += struct.pack(order + "HHI", tag, kind, len(values)) + field
    out += struct.pack(order + "I", 0) + tail
    assert len(out) == data_at
    return bytes(out) + b"".join(strips)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("channels", [1, 3])
def test_tiff_byte_orders_and_strips(tmp_path, order, channels):
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (45, 31) + ((3,) if channels == 3 else ())).astype(np.uint8)
    path = tmp_path / "c.tif"
    path.write_bytes(_raw_tiff(arr, order, rows_per_strip=7))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), arr)
    _assert_reads_as_pil(path, read_tiff)


def test_tiff_features_that_raise(tmp_path):
    arr = np.zeros((6, 5, 3), np.uint8)
    gray = np.zeros((6, 5), np.uint8)
    cases = {
        "planar configuration 2": _raw_tiff(arr, "<", 6, [(284, 3, [2])]),
        "compression 8": _raw_tiff(arr, "<", 6, [(259, 3, [8])]),
        "predictor 2": _raw_tiff(arr, "<", 6, [(317, 3, [2])]),
        "photometric interpretation 0": _raw_tiff(gray, ">", 6, [(262, 3, [0])]),
        "16": _raw_tiff(gray, "<", 6, [(258, 3, [16])]),
        "fill order 2": _raw_tiff(gray, "<", 6, [(266, 3, [2])]),
        "not a baseline TIFF": b"II+\x00" + _raw_tiff(gray, "<", 6)[4:],
        "strip 0 is truncated": _raw_tiff(gray, "<", 6)[:-5],
    }
    for match, data in cases.items():
        path = tmp_path / "bad.tif"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=match) as err:
            read_tiff(path)
        assert str(path) in str(err.value)
    # 16-bit and CMYK files as PIL writes them
    for name, im in (("i16", Image.fromarray(np.zeros((4, 4), np.uint16))),
                     ("cmyk", Image.new("CMYK", (4, 4)))):
        path = tmp_path / f"{name}.tif"
        im.save(path)
        with pytest.raises(ValueError, match="not supported"):
            read_tiff(path)
