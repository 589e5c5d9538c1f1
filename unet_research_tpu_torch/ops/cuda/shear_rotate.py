"""Rotation of a fan of angles as three shears, kernel K4 and its plain version.

Replaces unet_research_tpu/ops/pallas/shear_rotate.py::rotate_fan (kernel
`_row_resample_kernel`, called through `_row_resample`, shear_rotate.py:79-166):
each member is an exact quarter turn (rot90) on a square S x S canvas, then
three 1-D per-line fractional shifts with linear taps and zero fill (an
x-shear, a y-shear, an x-shear), then a crop back to (H, W). The result is
the rotation CCW about ((W-1)/2, (H-1)/2) with zero fill, up to the
shear-vs-bilinear interpolation difference of the JAX function.

Source: csrc/shear_rotate.cu. Bound: memory. At the rotational engine's
chunk (K = 16 members of 584x565, float32) the forward fan reads the one
image (1.3 MB) and writes 21.1 MB, 6.7 us at 3.35 TB/s on an H100 SXM; the
inverse fan reads and writes 21.1 MB each, 12.6 us. The kernel makes one
launch per 128 members: a block computes one TILE of one member's output
from windows of the canvas and of the two intermediates in shared memory
(`tile_windows` states their arithmetic, `window_limits` bounds their
sizes), so no (K, S, S) intermediate exists. The TPU kernel's 8-row strips,
its per-strip roll base and pltpu.roll exist because Mosaic has no per-lane
gather; here each thread computes its own source index.

The canvas keeps the JAX package's 128-aligned size. The kernel does not
need the alignment, but S sets the canvas centre (S-1)/2 and the content
offsets (py, px), and every per-line shift depends on them: only the same S
gives the same shift tables, and so the same numbers, as JAX.

`fan_params` computes every per-member scalar on the host in float32 torch
ops in JAX's order; the kernel and the plain version read the same values,
form each shift as slope * line + offset and each blend as
t1 * (1 - f) + t2 * f in round-to-nearest float32 without contraction, so
the two agree bit for bit on the card.

Two launch paths. `rotate_fan` computes a call's scalars on the host and
passes them as a kernel parameter. `rotate_fan_table` reads them from a
`MemberTable` on the card at a chunk index on the card: the rotational
engine builds the table once, from `fan_params` of each chunk on the host
(the card's cos, sin and tan may differ from the CPU's by an ulp, and the
tie angles 45 + 90k depend on the float32 order), and a CUDA graph of its
chunk replays one launch for every chunk. The table's `window_limits` are
taken over all its rows, so one shared-memory size serves every chunk.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from unet_research_tpu_torch.ops.cuda.build import check, load_library

_DEG2RAD = np.float32(np.pi / 180)
_HALF_PI = np.float32(np.pi / 2)
# Under jit, XLA folds deg2rad(a) / (pi/2) into a * (f32(pi/180) / f32(pi/2)):
# at 135 degrees that gives 1.4999999 where the unfolded quotient gives 1.5,
# so the JAX function turns by q = 1 and phi = +45 there (q = -1 at -135),
# where an eager computation would take q = 2 and phi = -45. Both are valid
# rotations, but their interpolation differs by up to 0.28 on noise. The
# folded constant reproduces the jitted choice at every tie 45 + 90k.
_QUARTERS_PER_DEG = np.float32(_DEG2RAD / _HALF_PI)
# Output rows x columns of the tile one block computes (csrc/shear_rotate.cu
# TI, TJ; the launch refuses another).
TILE = (31, 64)
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = load_library("shear_rotate")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.shear_rotate_launch.argtypes = [p, p, p] + [i] * 12 + [p]
        lib.shear_rotate_launch.restype = i
        lib.shear_rotate_table_launch.argtypes = [p, p, i, p, p] + [i] * 12 + [p]
        lib.shear_rotate_table_launch.restype = i
        _lib = lib
    return _lib


def canvas_size(h: int, w: int) -> int:
    """The JAX package's square canvas: (1 + tan(pi/8)) * max(H, W) + 2,
    rounded up to a multiple of 128 (see the module note for why)."""
    s = int(math.ceil((1.0 + math.tan(math.pi / 8)) * max(h, w))) + 2
    return s + (-s) % 128


class FanParams(NamedTuple):
    """Per-member scalars, (K,) float32 on the CPU (qm int64). The three
    per-line shifts are A1(y) = r*y + t1 (pass 1, by row), B(x) = q*x + s
    (pass 2, by column) and A2(y) = r*y + t2 (pass 3, by row)."""

    qm: torch.Tensor
    phi: torch.Tensor
    r: torch.Tensor
    t1: torch.Tensor
    q: torch.Tensor
    s: torch.Tensor
    t2: torch.Tensor


def fan_params(angles_deg, h: int, w: int) -> FanParams:
    """The scalars of rotate_fan (JAX shear_rotate.py:169-208 and
    `_pass_params` :135-143), in float32 in the same order."""
    a = torch.as_tensor(angles_deg).detach().to("cpu", torch.float32)
    S = canvas_size(h, w)
    py, px = (S - h) // 2, (S - w) // 2
    theta = a * _DEG2RAD
    qi = torch.round(a * _QUARTERS_PER_DEG)  # half to even, as jnp.round
    phi = theta - qi * _HALF_PI
    qm = torch.remainder(qi.to(torch.int64), 4)
    cc = (S - 1) / 2.0
    cly = py + (h - 1) / 2.0
    clx = px + (w - 1) / 2.0
    dy, dx = cly - cc, clx - cc
    quarter = qm.to(torch.float32) * _HALF_PI
    cosq, sinq = torch.cos(quarter), torch.sin(quarter)
    c2x = cc + cosq * dx + sinq * dy
    c2y = cc - sinq * dx + cosq * dy
    cosp, sinp = torch.cos(phi), torch.sin(phi)
    e_x = c2x - (cosp * clx - sinp * cly)
    e_y = c2y - (sinp * clx + cosp * cly)
    r = -torch.tan(phi / 2)
    q = torch.sin(phi)
    t1 = -r * cly
    t2 = e_x - r * e_y - t1
    s = e_y - q * t2
    return FanParams(qm, phi, r, t1, q, s, t2)


class Windows(NamedTuple):
    """One tile's windows per member, (K, tiles down, tiles across) int64,
    each an inclusive range in canvas coordinates: pass 3 reads r2 at
    columns [c0, c1], pass 2 reads r1 at rows [r0, r1] (of those columns),
    pass 1 reads the canvas at columns [v0, v1] (of those rows)."""

    c0: torch.Tensor
    c1: torch.Tensor
    r0: torch.Tensor
    r1: torch.Tensor
    v0: torch.Tensor
    v1: torch.Tensor


def tile_windows(p: FanParams, h: int, w: int) -> Windows:
    """The windows that csrc/shear_rotate.cu computes for each tile, in the
    same float32 operations. A floored shift floor(slope * line + offset) is
    monotone in the line, so over a range of lines it is extreme at the two
    ends: each window is the range before it, widened by the floors there
    and by one for the second tap."""
    S = canvas_size(h, w)
    py, px = (S - h) // 2, (S - w) // 2
    ti, tj = TILE
    i0, j0 = torch.arange(0, h, ti), torch.arange(0, w, tj)
    y0 = (py + i0)[None, :, None]
    y1 = (py + torch.clamp(i0 + ti, max=h) - 1)[None, :, None]
    x0 = (px + j0)[None, None, :]
    x1 = (px + torch.clamp(j0 + tj, max=w) - 1)[None, None, :]

    def floors(slope, offset, a, b):
        def at(line):
            return torch.floor(slope[:, None, None] * line.to(torch.float32)
                               + offset[:, None, None]).to(torch.int64)
        fa, fb = at(a), at(b)
        return torch.minimum(fa, fb), torch.maximum(fa, fb)

    lo, hi = floors(p.r, p.t2, y0, y1)
    c0, c1 = x0 + lo, x1 + hi + 1
    lo, hi = floors(p.q, p.s, c0, c1)
    r0, r1 = y0 + lo, y1 + hi + 1
    lo, hi = floors(p.r, p.t1, r0, r1)
    return Windows(c0, c1, r0, r1, c0 + lo, c1 + hi + 1)


def window_limits(p: FanParams, s: int) -> tuple[int, int, int]:
    """Bounds on a tile's r2 columns, r1 rows and canvas columns for every
    member of the fan, which size the kernel's shared memory. Over n lines a
    floored shift moves by at most floor(|slope| * (n - 1) + eps) + 1, where
    eps covers the float32 rounding of slope * line + offset at canvas size
    s; a window holds the lines of the range before it, one more for the
    second tap, and that spread."""
    ti, tj = TILE
    eps = s * 2.0 ** -18
    r, q = float(p.r.abs().max()), float(p.q.abs().max())

    def span(lines, slope, n):
        return lines + 2 + math.floor(slope * (n - 1) + eps)

    cols = span(tj, r, ti)
    rows = span(ti, q, cols)
    return cols, rows, span(cols, r, rows)


def smem_bytes(limits) -> int:
    """Shared memory of one block (csrc/shear_rotate.cu::launch): the canvas
    window at an odd pitch, the sheared r1 window, pass 2's floors and
    fractions, and the staged span of each canvas row or column."""
    cols, rows, canvas = limits
    return 4 * (rows * (canvas | 1) + cols * (((TILE[0] + 1) | 1) + 2) + 2 * max(rows, canvas))


def _check(img, angles_deg):
    n, h, w, c = img.shape
    if c != 1:
        raise ValueError("rotate_fan expects single-channel NHWC")
    k = int(torch.as_tensor(angles_deg).shape[0])
    if n not in (1, k):
        raise ValueError("img batch must be 1 or len(angles)")
    return k, h, w


def _resample_rows(img, delta):
    """out[k, y, x] = (1-f) * img[k, y, x+d] + f * img[k, y, x+d+1] with
    d = floor(delta[k, y]), f = delta[k, y] - d, zeros outside [0, S)."""
    K, rows, S = img.shape
    d = torch.floor(delta)
    f = (delta - d)[:, :, None]
    src = torch.arange(S, device=img.device)[None, None, :] + d.to(torch.int64)[:, :, None]

    def tap(idx):
        valid = (idx >= 0) & (idx < S)
        vals = torch.gather(img, 2, idx.clamp(0, S - 1))
        return torch.where(valid, vals, torch.zeros((), dtype=img.dtype, device=img.device))

    return tap(src) * (1 - f) + tap(src + 1) * f


def rotate_fan_plain(img: torch.Tensor, angles_deg) -> torch.Tensor:
    """K4's plain version: the canvas, a per-member torch.rot90, three
    gathers along lines (x, then y on the transpose, then x) and the crop."""
    _check(img, angles_deg)
    return _rotate_plain(img, fan_params(angles_deg, img.shape[1], img.shape[2]))


def _rotate_plain(img: torch.Tensor, p: FanParams) -> torch.Tensor:
    K, h, w = len(p.qm), img.shape[1], img.shape[2]
    S = canvas_size(h, w)
    py, px = (S - h) // 2, (S - w) // 2
    dev = img.device
    canvas = torch.zeros((K, S, S), dtype=img.dtype, device=dev)
    canvas[:, py:py + h, px:px + w] = img[:, :, :, 0]
    canvas = torch.stack([torch.rot90(canvas[i], int(p.qm[i]), dims=(0, 1))
                          for i in range(K)])
    lines = torch.arange(S, dtype=torch.float32, device=dev)[None, :]

    def shifts(slope, offset):
        return slope.to(dev)[:, None] * lines + offset.to(dev)[:, None]

    out = _resample_rows(canvas, shifts(p.r, p.t1))
    out = _resample_rows(out.transpose(1, 2), shifts(p.q, p.s)).transpose(1, 2)
    out = _resample_rows(out, shifts(p.r, p.t2))
    return out[:, py:py + h, px:px + w, None]


def rotate_fan(img: torch.Tensor, angles_deg) -> torch.Tensor:
    """Rotate a float32 (1 or K, H, W, 1) image by K angles in degrees (CCW,
    zero fill) -> (K, H, W, 1). A batch of K rotates member k by angle k
    (the inverse warp of a segmentation fan). The angles may lie on any
    device; their per-member scalars are computed on the host (angles on the
    card cost a synchronisation) and reach the kernel as launch parameters,
    with no copy. CPU tensors take the plain version."""
    K, h, w = _check(img, angles_deg)
    if not img.is_cuda:
        return rotate_fan_plain(img, angles_deg)
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("rotate_fan: img must be contiguous float32 NHWC")
    S = canvas_size(h, w)
    p = fan_params(angles_deg, h, w)
    dev = img.device
    members = member_rows(p)
    out = torch.empty((K, h, w, 1), dtype=torch.float32, device=dev)
    status = _library().shear_rotate_launch(
        img.data_ptr(), members.data_ptr(), out.data_ptr(), K, img.shape[0], h, w, S,
        (S - h) // 2, (S - w) // 2, *TILE, *window_limits(p, S),
        torch.cuda.current_stream(dev).cuda_stream)
    check(status, "rotate_fan")
    rotate_fan.launches += 1
    return out


rotate_fan.launches = 0


def member_rows(p: FanParams) -> torch.Tensor:
    """(K, 6) int32 rows on the CPU, the kernel's Member: the float32 bits of
    r, t1, q, s, t2, then qm."""
    return torch.cat([torch.stack([p.r, p.t1, p.q, p.s, p.t2], dim=1).view(torch.int32),
                      p.qm.to(torch.int32)[:, None]], dim=1)


class MemberTable(NamedTuple):
    """The Member rows of a fan of equal chunks at (h, w): `rows` (chunks *
    members, 6) int32 on one device, chunk c in rows [c * members, (c + 1) *
    members); `limits`: window_limits over every row."""

    rows: torch.Tensor
    members: int
    h: int
    w: int
    limits: tuple

    @property
    def chunks(self) -> int:
        return self.rows.shape[0] // self.members


def member_table(angle_chunks, h: int, w: int, device) -> MemberTable:
    """The table of the chunks' rows, each chunk's from fan_params of its
    angles on the host (the rows rotate_fan would compute for it), moved to
    `device` in one copy."""
    if len({len(a) for a in angle_chunks}) != 1:
        raise ValueError("member_table: the chunks must have one size")
    params = [fan_params(a, h, w) for a in angle_chunks]
    whole = FanParams(*(torch.cat(fields) for fields in zip(*params)))
    return MemberTable(member_rows(whole).to(device), len(angle_chunks[0]), h, w,
                       window_limits(whole, canvas_size(h, w)))


def table_params(table: MemberTable, index) -> FanParams:
    """The scalars of chunk `index` of a table, read back from its rows on
    the host (phi, which no row holds, is None)."""
    i = int(index)
    if not 0 <= i < table.chunks:
        raise IndexError(f"chunk {i} of a table of {table.chunks}")
    rows = table.rows[i * table.members:(i + 1) * table.members].cpu()
    r, t1, q, s, t2 = rows[:, :5].contiguous().view(torch.float32).unbind(1)
    return FanParams(rows[:, 5].to(torch.int64), None, r, t1, q, s, t2)


def _check_table(img, table: MemberTable):
    n, h, w, c = img.shape
    if c != 1:
        raise ValueError("rotate_fan_table expects single-channel NHWC")
    if n not in (1, table.members):
        raise ValueError("img batch must be 1 or the table's members per chunk")
    if (h, w) != (table.h, table.w):
        raise ValueError(f"img is {h}x{w}, the table's fan {table.h}x{table.w}")


def rotate_fan_table_plain(img: torch.Tensor, table: MemberTable, index) -> torch.Tensor:
    """rotate_fan_table's plain version: rotate_fan_plain on the chunk's
    rows, read back on the host."""
    _check_table(img, table)
    return _rotate_plain(img, table_params(table, index))


def rotate_fan_table(img: torch.Tensor, table: MemberTable, index: torch.Tensor) -> torch.Tensor:
    """rotate_fan of the members of chunk `index` of `table` -> (K, H, W, 1):
    the kernel reads the chunk's rows on the card at the chunk index, a (1,)
    int64 tensor on the table's device, so a launch does no host work that
    depends on the chunk and a CUDA graph can replay it for each (an index
    past the table traps on the card). One launch per call. CPU tensors
    take the plain version."""
    _check_table(img, table)
    if not img.is_cuda:
        return rotate_fan_table_plain(img, table, index)
    if img.dtype != torch.float32 or not img.is_contiguous():
        raise ValueError("rotate_fan_table: img must be contiguous float32 NHWC")
    if table.rows.device != img.device or index.device != img.device:
        raise ValueError("rotate_fan_table: the table and the index must be on img's device")
    if index.dtype != torch.int64 or index.numel() != 1:
        raise ValueError("rotate_fan_table: index must be one int64")
    K, h, w = table.members, table.h, table.w
    S = canvas_size(h, w)
    out = torch.empty((K, h, w, 1), dtype=torch.float32, device=img.device)
    status = _library().shear_rotate_table_launch(
        img.data_ptr(), table.rows.data_ptr(), table.rows.shape[0], index.data_ptr(),
        out.data_ptr(), K, img.shape[0], h, w, S, (S - h) // 2, (S - w) // 2, *TILE,
        *table.limits, torch.cuda.current_stream(img.device).cuda_stream)
    check(status, "rotate_fan_table")
    rotate_fan_table.launches += 1
    return out


rotate_fan_table.launches = 0
