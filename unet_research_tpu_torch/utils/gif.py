"""GIF reading on numpy: the port's stand-in for PIL's GIF decoder (the port
depends on numpy, torch and the standard library only; DRIVE ships its
FOV masks and manual segmentations as GIF).

`read_gif(path, mode)` gives what `Image.open(path).convert(mode)` gives,
for mode "RGB" (uint8 (H, W, 3)) or "L" (uint8 (H, W)), from the first
image of the file: GIF87a and GIF89a, global and local colour tables, LZW
with minimum code sizes 2-8 (utils/lzw.py), interlaced or not. Indices map
through the colour table, whose missing entries are PIL's gray ramp (i, i,
i), so a file without a table or with the identity table reads as PIL's
mode "L" does; colour becomes gray with Pillow's luma (`png._luma`).
Transparency and later frames are ignored, as `convert` ignores them. A
first image that does not cover the logical screen exactly raises
ValueError naming the file, as does any corrupt or truncated data.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from unet_research_tpu_torch.utils.lzw import lzw_decode
from unet_research_tpu_torch.utils.png import _luma

_MODES = ("RGB", "L")


def _sub_blocks(data: bytes, pos: int, name: str):
    """(payload of the sub-block chain starting at pos, position after its
    terminator)."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: truncated GIF (a data block has no terminator)")
        size = data[pos]
        pos += 1
        if size == 0:
            return b"".join(parts), pos
        parts.append(data[pos:pos + size])
        pos += size


def _colour_table(data: bytes, pos: int, flags: int, name: str):
    """(the (N, 3) table that the flags announce at pos, or None; the
    position after it)."""
    if not flags & 0x80:
        return None, pos
    size = 3 << ((flags & 7) + 1)
    if pos + size > len(data):
        raise ValueError(f"{name}: truncated GIF colour table")
    return np.frombuffer(data[pos:pos + size], np.uint8).reshape(-1, 3), pos + size


def _interlaced_rows(h: int) -> np.ndarray:
    """The image rows in the order an interlaced GIF stores them."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                           np.arange(1, h, 2)])


def read_gif(path, mode: str = "L") -> np.ndarray:
    """The first image of a GIF file as PIL's `convert(mode)` gives it:
    uint8 (H, W, 3) for "RGB", (H, W) for "L"."""
    if mode not in _MODES:
        raise ValueError(f"read_gif: mode must be one of {_MODES}, not {mode!r}")
    name = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    table, pos = _colour_table(data, 13, flags, name)
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: GIF without an image")
        kind = data[pos]
        if kind == 0x21:  # extension: label, then sub-blocks
            _, pos = _sub_blocks(data, pos + 2, name)
        elif kind == 0x2C:
            break
        else:
            raise ValueError(f"{name}: GIF block 0x{kind:02x} before the first image")
    if pos + 11 > len(data):
        raise ValueError(f"{name}: truncated GIF image descriptor")
    left, top, w, h, flags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
    if (left, top, w, h) != (0, 0, width, height):
        raise ValueError(f"{name}: the first GIF image ({w}x{h} at {left},{top}) does not "
                         f"cover the {width}x{height} screen; not supported")
    local, pos = _colour_table(data, pos + 10, flags, name)
    if local is not None:
        table = local
    literal_bits = data[pos]
    if not 2 <= literal_bits <= 8:
        raise ValueError(f"{name}: GIF LZW minimum code size {literal_bits} is not in 2-8")
    codes, _ = _sub_blocks(data, pos + 1, name)
    pixels = lzw_decode(codes, literal_bits, tiff=False, limit=w * h, name=name)
    if len(pixels) < w * h:
        raise ValueError(f"{name}: GIF image data is truncated ({len(pixels)} of {w * h} pixels)")
    idx = np.frombuffer(pixels, np.uint8).reshape(h, w)
    if flags & 0x40:
        rows = np.empty_like(idx)
        rows[_interlaced_rows(h)] = idx
        idx = rows
    lut = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    if table is not None:
        lut[:len(table)] = table
    return lut[idx] if mode == "RGB" else _luma(lut)[idx]
