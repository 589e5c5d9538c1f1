"""PNG reading and writing on numpy and zlib: the port's stand-in for PIL
(the port depends on numpy, torch and the standard library only).

`read_png(path)` gives what PIL's `Image.open(path).convert("L")` gives for
the non-interlaced PNGs this pipeline meets: 8-bit gray (L), gray + alpha
(LA), RGB, RGBA and palette (P, also at 1, 2 and 4 bits, as PIL writes small
palettes), and 1-bit gray (PIL mode "1", read as 0/255). Colour becomes gray
with Pillow's integer luma, (R*19595 + G*38470 + B*7471 + 0x8000) >> 16;
alpha is dropped. Any other file (16-bit samples, Adam7 interlacing, 2- or
4-bit gray) raises ValueError naming the file; nothing is approximated.

`write_png(path, img)` writes uint8 (H, W) gray or (H, W, 3) RGB in one
IDAT, every row with filter 0.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type, and the bit depths read for it
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(crc) != 4 or zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: corrupt {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: truncated PNG (no IEND chunk)")


def _unfilter(types: np.ndarray, filtered: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of `filtered` (H, stride) uint8; `types` (H,)
    are the row filter bytes and `bpp` the bytes per pixel (at least 1).

    Rows of None, Sub and Up are reconstructed a row at a time (Sub as a
    running sum per byte lane). Average and Paeth depend on the pixel to the
    left and the row above, so an image with such rows is reconstructed
    along anti-diagonals of the pixel grid, whose positions depend only on
    the two diagonals before. The grid is held skewed, diagonal d in row
    d + 2 and pixel (r, j) at column r + 1 of it, so that a diagonal's left,
    upper and upper-left neighbours are three contiguous slices (zeros where
    they fall outside the image)."""
    h, stride = filtered.shape
    if np.all(types <= 2):
        out = np.empty_like(filtered)
        prev = np.zeros(stride, np.uint8)
        for r in range(h):
            line = filtered[r]
            if types[r] == 1:
                line = line.reshape(-1, bpp).cumsum(axis=0, dtype=np.uint8).reshape(-1)
            elif types[r] == 2:
                line = line + prev
            out[r] = prev = line
        return out
    n = stride // bpp
    rr, jj = np.meshgrid(np.arange(h), np.arange(n), indexing="ij")
    filt = np.zeros((h + n - 1, h, bpp), np.int16)
    filt[rr + jj, rr] = filtered.reshape(h, n, bpp)
    skew = np.zeros((h + n + 1, h + 1, bpp), np.int16)
    kinds = types.astype(np.intp)[:, None]
    for d in range(h + n - 1):
        lo, hi = max(0, d - n + 1), min(h - 1, d) + 1
        a, b, c = skew[d + 1, lo + 1:hi + 1], skew[d + 1, lo:hi], skew[d, lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(kinds[lo:hi], (0, a, b, (a + b) >> 1, paeth))
        skew[d + 2, lo + 1:hi + 1] = (filt[d, lo:hi] + pred) & 255
    return skew[rr + jj + 2, rr + 1].reshape(h, stride).astype(np.uint8)


def _unpack(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """Samples of `depth` < 8 bits, most significant first, -> (H, width)."""
    bits = np.unpackbits(rows, axis=1)
    bits = bits.reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width]


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_png(path) -> np.ndarray:
    """The 8-bit gray image (H, W) uint8 of a PNG file, equal to PIL's
    `Image.open(path).convert("L")` (see the module docstring for what is
    read)."""
    name = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"{name}: bit depth {depth} with colour type {ctype} is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{name}: image data is truncated")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{name}: unknown row filter {int(rows[:, 0].max())}")
    recon = _unfilter(rows[:, 0], rows[:, 1:], max(1, channels * depth // 8))
    if depth < 8:
        samples = _unpack(recon, depth, width)
        if ctype == 0:  # mode "1"
            return samples * np.uint8(255)
    else:
        samples = recon.reshape(height, width, channels)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return _luma(lut)[samples.reshape(height, width)]
    if ctype in (0, 4):
        return np.ascontiguousarray(samples[..., 0])
    return _luma(samples[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, img) -> None:
    """Write uint8 (H, W) as 8-bit gray or (H, W, 3) as 8-bit RGB."""
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)) \
            or 0 in a.shape:
        raise ValueError(f"write_png needs uint8 (H, W) or (H, W, 3), got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
