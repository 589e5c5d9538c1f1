"""TIFF reading on numpy: the port's stand-in for PIL's TIFF decoder (the
port depends on numpy, torch and the standard library only; DRIVE ships its
images as TIFF).

`read_tiff(path, mode)` gives what `Image.open(path).convert(mode)` gives,
for mode "RGB" (uint8 (H, W, 3)) or "L" (uint8 (H, W)), from the first
image of a baseline TIFF: byte order II or MM; 8 bits per sample; 1 sample
(BlackIsZero gray) or 3 (RGB), interleaved (planar configuration 1); one or
more strips; compression 1 (none), 5 (LZW, utils/lzw.py, with or without
the horizontal predictor 2) or 32773 (PackBits). Gray becomes RGB by
repetition and RGB becomes gray with Pillow's luma (`png._luma`). Any other
feature (tiles, other sample sizes or counts, WhiteIsZero or palette
images, planar configuration 2, other compressions or predictors, old-style
LZW, reversed fill order) raises ValueError naming the file.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from unet_research_tpu_torch.utils.lzw import lzw_decode
from unet_research_tpu_torch.utils.png import _luma

_MODES = ("RGB", "L")
# field type -> (struct code, bytes per value): SHORT and LONG, the types of
# every tag read here
_TYPES = {3: ("H", 2), 4: ("I", 4)}
(_WIDTH, _HEIGHT, _BITS, _COMPRESSION, _PHOTOMETRIC, _FILL_ORDER, _STRIP_OFFSETS,
 _SAMPLES, _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR, _TILE_WIDTH,
 _SAMPLE_FORMAT) = (256, 257, 258, 259, 262, 266, 273, 277, 278, 279, 284, 317, 322, 339)
_NEEDED = (_WIDTH, _HEIGHT, _STRIP_OFFSETS, _STRIP_COUNTS)


def _tags(data: bytes, order: str, name: str) -> dict:
    """{tag: tuple of values} of the first IFD's SHORT and LONG fields."""
    (offset,) = struct.unpack(order + "I", data[4:8])
    if offset + 2 > len(data):
        raise ValueError(f"{name}: truncated TIFF (no first IFD)")
    (count,) = struct.unpack(order + "H", data[offset:offset + 2])
    tags = {}
    for i in range(count):
        at = offset + 2 + 12 * i
        if at + 12 > len(data):
            raise ValueError(f"{name}: truncated TIFF IFD")
        tag, kind, n = struct.unpack(order + "HHI", data[at:at + 8])
        if kind not in _TYPES:
            continue  # text, rationals and the like: nothing here reads them
        code, size = _TYPES[kind]
        where = at + 8 if n * size <= 4 else struct.unpack(order + "I", data[at + 8:at + 12])[0]
        if where + n * size > len(data):
            raise ValueError(f"{name}: TIFF tag {tag} points past the end of the file")
        tags[tag] = struct.unpack(f"{order}{n}{code}", data[where:where + n * size])
    return tags


def _packbits(data: bytes, limit: int, name: str) -> bytes:
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n and len(out) < limit:
        head = data[pos]
        if head < 128:  # head + 1 literal bytes
            out += data[pos + 1:pos + 2 + head]
            pos += 2 + head
        elif head > 128:  # the next byte 257 - head times
            if pos + 1 >= n:
                raise ValueError(f"{name}: truncated PackBits run")
            out += data[pos + 1:pos + 2] * (257 - head)
            pos += 2
        else:  # 128: no operation
            pos += 1
    return bytes(out[:limit])


def _decode_strip(raw: bytes, compression: int, limit: int, name: str) -> bytes:
    if compression == 1:
        return raw[:limit]
    if compression == 5:
        if raw[:2] == b"\x00\x01":
            raise ValueError(f"{name}: old-style (LSB-first) TIFF LZW is not supported")
        return lzw_decode(raw, 8, tiff=True, limit=limit, name=name)
    return _packbits(raw, limit, name)


def read_tiff(path, mode: str = "RGB") -> np.ndarray:
    """The first image of a baseline TIFF file as PIL's `convert(mode)`
    gives it: uint8 (H, W, 3) for "RGB", (H, W) for "L"."""
    if mode not in _MODES:
        raise ValueError(f"read_tiff: mode must be one of {_MODES}, not {mode!r}")
    name = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    order = {b"II*\x00": "<", b"MM\x00*": ">"}.get(data[:4])
    if order is None:
        raise ValueError(f"{name}: not a baseline TIFF file (BigTIFF is not supported)")
    tags = _tags(data, order, name)
    missing = [t for t in _NEEDED if t not in tags]
    if missing:
        raise ValueError(f"{name}: TIFF without the required tags {missing}"
                         + (" (a tiled TIFF is not supported)" if _TILE_WIDTH in tags else ""))
    w, h = tags[_WIDTH][0], tags[_HEIGHT][0]
    spp = tags.get(_SAMPLES, (1,))[0]
    bits = tags.get(_BITS, (1,) * spp)
    photometric = tags.get(_PHOTOMETRIC, (None,))[0]
    compression = tags.get(_COMPRESSION, (1,))[0]
    predictor = tags.get(_PREDICTOR, (1,))[0]
    checks = (
        (set(bits) == {8}, f"{bits} bits per sample"),
        ((spp, photometric) in ((1, 1), (3, 2)),
         f"{spp} samples per pixel with photometric interpretation {photometric}"),
        (tags.get(_PLANAR, (1,))[0] == 1, "planar configuration 2"),
        (compression in (1, 5, 32773), f"compression {compression}"),
        (predictor == 1 or (predictor == 2 and compression == 5), f"predictor {predictor}"),
        (tags.get(_FILL_ORDER, (1,))[0] == 1, "fill order 2"),
        (set(tags.get(_SAMPLE_FORMAT, (1,))) == {1}, "a sample format other than unsigned"),
    )
    for ok, feature in checks:
        if not ok:
            raise ValueError(f"{name}: TIFF with {feature} is not supported")
    rows_per_strip = min(tags.get(_ROWS_PER_STRIP, (h,))[0], h)
    offsets, counts = tags[_STRIP_OFFSETS], tags[_STRIP_COUNTS]
    stride = w * spp
    strips = []
    for i, (offset, count) in enumerate(zip(offsets, counts)):
        rows = min(rows_per_strip, h - i * rows_per_strip)
        if rows <= 0:
            break
        raw = _decode_strip(data[offset:offset + count], compression, rows * stride, name)
        if len(raw) < rows * stride:
            raise ValueError(f"{name}: TIFF strip {i} is truncated ({len(raw)} of "
                             f"{rows * stride} bytes)")
        strip = np.frombuffer(raw, np.uint8).reshape(rows, w, spp)
        if predictor == 2:  # horizontal differencing, per sample, modulo 256
            strip = strip.cumsum(axis=1, dtype=np.uint8)
        strips.append(strip)
    img = np.concatenate(strips) if strips else np.empty((0, w, spp), np.uint8)
    if img.shape[0] != h:
        raise ValueError(f"{name}: TIFF strips hold {img.shape[0]} of {h} rows")
    if spp == 1:
        gray = img[..., 0]
        return np.repeat(gray[..., None], 3, axis=2) if mode == "RGB" else np.ascontiguousarray(gray)
    return np.ascontiguousarray(img) if mode == "RGB" else _luma(img)
