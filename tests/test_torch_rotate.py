"""The port's rotation warps against the JAX package on the same inputs.

- ops/cuda/shear_rotate.py: canvas_size, the quarter turn of fan_params
  against the jitted JAX choice at every whole and half degree in
  +-1..359, and rotate_fan_plain against JAX rotate_fan (its Pallas kernel in
  interpret mode, as tests/test_shear_rotate.py runs it) on [0, 1] noise,
  single-image and batched-inverse forms, all eight tie angles 45 + 90k
  included: atol 1e-4 (about 1.4e-5 measured; the margin covers a shift
  that sits one ulp from an integer and floors the other way, where the
  two taps swap weights);
- ops/cuda/shear_rotate.py::tile_windows, the windows K4 stages per output
  tile, against the indices the plain version's three passes read (every
  line's floored shift formed as rotate_fan_plain forms it), for every
  member of the engine's fans (+-1..359 degrees at 584x565) and the card
  tests' shapes and angles; and window_limits, which sizes the kernel's
  shared memory, against those windows and the 227 KB a block may use;
- ops/image.py::rotate_bilinear against JAX rotate_bilinear: atol 1e-5
  (float32 sin/cos of two libraries), and against the torchvision 0.10
  rotate that tests/test_image_ops.py rebuilds from grid_sample, at its
  tolerance (rtol 1e-4, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_research_tpu.ops.image import rotate_bilinear as jax_rotate_bilinear
from unet_research_tpu.ops.pallas.shear_rotate import canvas_size as jax_canvas_size
from unet_research_tpu.ops.pallas.shear_rotate import rotate_fan as jax_rotate_fan
from unet_research_tpu_torch.ops.cuda import shear_rotate as sr
from unet_research_tpu_torch.ops.image import rotate_bilinear
from test_image_ops import torch_rotate_golden
from test_torch_cuda_kernels import ROTATE_CASES

TIES = [45.0, 135.0, 225.0, 315.0, -45.0, -135.0, -225.0, -315.0]
FAN = np.asarray(TIES + [0.0, 1.0, 7.0, 33.5, 90.0, 180.0, 270.0, 359.0, -90.0], np.float32)


@jax.jit
def _jax_quarter_turn(angles):
    """The lines of JAX rotate_fan (shear_rotate.py:176-179) that choose the
    quarter turn, jitted as rotate_fan is."""
    theta = jnp.deg2rad(angles.astype(jnp.float32))
    qi = jnp.round(theta / (jnp.pi / 2)).astype(jnp.int32)
    return ((qi % 4) + 4) % 4, theta - qi.astype(jnp.float32) * (jnp.pi / 2)


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    small = rng.random((h // 8 + 2, w // 8 + 2), np.float32)
    img = jnp.clip(jax.image.resize(jnp.asarray(small), (h, w), "cubic"), 0, 1)
    return np.array(img)[None, :, :, None]


@pytest.mark.parametrize("h,w", [(584, 565), (72, 56), (40, 40), (33, 100), (1, 1), (128, 90)])
def test_canvas_size_matches_jax(h, w):
    assert sr.canvas_size(h, w) == jax_canvas_size(h, w)


def test_quarter_turn_matches_jitted_jax():
    whole = np.arange(1, 360, dtype=np.float32)
    half = whole - np.float32(0.5)
    angles = np.concatenate([whole, -whole, half, -half])
    jq, jphi = _jax_quarter_turn(jnp.asarray(angles))
    p = sr.fan_params(torch.from_numpy(angles), 72, 56)
    np.testing.assert_array_equal(p.qm.numpy(), np.asarray(jq))
    np.testing.assert_allclose(p.phi.numpy(), np.asarray(jphi), atol=1e-6)
    # the ties take the jitted choice: +45 residual at 135, q = -1 at -135
    ties = sr.fan_params(torch.tensor([135.0, -135.0]), 72, 56)
    assert ties.qm.tolist() == [1, 3]


@pytest.mark.parametrize("h,w", [(72, 56), (40, 40)])
def test_rotate_fan_plain_matches_jax(h, w):
    rng = np.random.default_rng(h)
    img = rng.random((1, h, w, 1), dtype=np.float32)
    ref = np.asarray(jax_rotate_fan(jnp.asarray(img), jnp.asarray(FAN), interpret=True))
    out = sr.rotate_fan_plain(torch.from_numpy(img), torch.from_numpy(FAN))
    assert out.shape == (len(FAN), h, w, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("h,w", [(72, 56), (40, 40)])
def test_rotate_fan_plain_batched_inverse_matches_jax(h, w):
    rng = np.random.default_rng(h + 1)
    img = rng.random((len(FAN), h, w, 1), dtype=np.float32)
    ref = np.asarray(jax_rotate_fan(jnp.asarray(img), jnp.asarray(-FAN), interpret=True))
    out = sr.rotate_fan_plain(torch.from_numpy(img), torch.from_numpy(-FAN))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_cpu_wrapper_takes_the_plain_route():
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((1, 24, 20, 1), dtype=np.float32))
    angles = torch.tensor([135.0, 10.0, -45.0])
    before = sr.rotate_fan.launches
    out = sr.rotate_fan(img, angles)
    assert sr.rotate_fan.launches == before
    assert torch.equal(out, sr.rotate_fan_plain(img, angles))


@pytest.mark.parametrize("shape,n_angles", [((2, 5, 4, 1), 3), ((4, 5, 4, 1), 3), ((1, 5, 4, 2), 3)])
def test_rotate_fan_rejects_what_jax_rejects(shape, n_angles):
    with pytest.raises(ValueError):
        sr.rotate_fan(torch.zeros(shape), torch.zeros(n_angles))


def _floors(slope, offset, lines):
    """floor(slope * line + offset) in float32 for member k's lines, k along
    the first axis: the shift rotate_fan_plain floors for a line."""
    view = (-1,) + (1,) * (lines.dim() - 1)
    return torch.floor(slope.view(view) * lines.to(torch.float32)
                       + offset.view(view)).to(torch.int64)


def _extremes(slope, offset, lo, hi, width):
    """Per tile, the least and greatest floored shift over its lines
    [lo, hi] (each tile's own range, at most `width` lines)."""
    lines = lo[..., None] + torch.arange(width)
    inside = lines <= hi[..., None]
    d = _floors(slope, offset, lines)
    big = torch.iinfo(torch.int64).max
    return (torch.where(inside, d, big).amin(-1), torch.where(inside, d, -big).amax(-1))


WINDOW_CASES = ([(584, 565, np.arange(1, 360, dtype=np.float32)),
                 (584, 565, -np.arange(1, 360, dtype=np.float32))]
                + [(h, w, np.asarray(a, np.float32)) for _, h, w, a in ROTATE_CASES])


@pytest.mark.parametrize("h,w,angles", WINDOW_CASES,
                         ids=[f"{h}x{w}-{len(a)}" for h, w, a in WINDOW_CASES])
def test_tile_windows_hold_what_the_plain_passes_read(h, w, angles):
    p = sr.fan_params(torch.from_numpy(angles), h, w)
    S = sr.canvas_size(h, w)
    py, px = (S - h) // 2, (S - w) // 2
    ti, tj = sr.TILE
    win = sr.tile_windows(p, h, w)
    k = len(angles)
    # each tile's output rows y0..y1 and columns x0..x1 in canvas coordinates
    i0, j0 = torch.arange(0, h, ti), torch.arange(0, w, tj)
    y0 = (py + i0)[None, :, None].expand(k, -1, len(j0))
    y1 = (py + torch.clamp(i0 + ti, max=h) - 1)[None, :, None].expand(k, -1, len(j0))
    x0 = (px + j0)[None, None, :]
    x1 = (px + torch.clamp(j0 + tj, max=w) - 1)[None, None, :]
    # pass 3: row y reads r2 at columns x + d3(y) and x + d3(y) + 1
    lo, hi = _extremes(p.r, p.t2, y0, y1, ti)
    c_lo, c_hi = x0 + lo, x1 + hi + 1
    assert bool((win.c0 <= c_lo).all() and (c_hi <= win.c1).all())
    # pass 2: column x reads r1 at rows y + d2(x) and y + d2(x) + 1
    lo, hi = _extremes(p.q, p.s, c_lo, c_hi, int((c_hi - c_lo).max()) + 1)
    r_lo, r_hi = y0 + lo, y1 + hi + 1
    assert bool((win.r0 <= r_lo).all() and (r_hi <= win.r1).all())
    # pass 1: row y reads the canvas at columns x + d1(y) and x + d1(y) + 1
    lo, hi = _extremes(p.r, p.t1, r_lo, r_hi, int((r_hi - r_lo).max()) + 1)
    assert bool((win.v0 <= c_lo + lo).all() and (c_hi + hi + 1 <= win.v1).all())
    # the windows fit the shared memory the launch asks for
    cols, rows, canvas = sr.window_limits(p, S)
    assert int((win.c1 - win.c0).max()) + 1 <= cols
    assert int((win.r1 - win.r0).max()) + 1 <= rows
    assert int((win.v1 - win.v0).max()) + 1 <= canvas
    assert sr.smem_bytes((cols, rows, canvas)) <= 227 * 1024


@pytest.mark.parametrize("batched", [False, True])
def test_rotate_bilinear_matches_jax(batched):
    rng = np.random.default_rng(11)
    angles = np.asarray([0.0, 90.0, 180.0, 13.0, -77.5, 135.0, 301.0], np.float32)
    n = len(angles) if batched else 1
    img = rng.random((n, 30, 23, 2), dtype=np.float32)
    out = rotate_bilinear(torch.from_numpy(img), torch.from_numpy(angles))
    assert out.shape == (len(angles), 30, 23, 2)
    for k, a in enumerate(angles):
        ref = np.asarray(jax_rotate_bilinear(jnp.asarray(img[k if batched else 0][None]), a))
        np.testing.assert_allclose(out[k].numpy(), ref[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("angle", [0.0, 1.0, 37.5, 90.0, 180.0, 271.0, -45.0, 359.0])
def test_rotate_bilinear_matches_torchvision_rotate(angle):
    x = np.random.default_rng(5).random((1, 37, 45, 2), dtype=np.float32)
    out = rotate_bilinear(torch.from_numpy(x), torch.tensor([angle]))
    ref = torch_rotate_golden(torch.from_numpy(x).permute(0, 3, 1, 2), angle)
    torch.testing.assert_close(out, ref.permute(0, 2, 3, 1), rtol=1e-4, atol=1e-5)


def test_zero_fill_outside():
    out = sr.rotate_fan(torch.ones((1, 32, 32, 1)), torch.tensor([45.0]))[0, :, :, 0]
    # the 45-degree rotation of a square leaves the corners zero-filled
    assert out[0, 0] < 1e-6 and out[0, -1] < 1e-6
    assert out[-1, 0] < 1e-6 and out[-1, -1] < 1e-6
    assert abs(float(out[16, 16]) - 1.0) < 1e-3


@pytest.mark.parametrize("angle", [0.0, 90.0, 180.0, 270.0])
def test_exact_multiples_of_90(angle):
    img = torch.from_numpy(_smooth(64, 48, seed=0))
    out = sr.rotate_fan(img, torch.tensor([angle]))
    ref = rotate_bilinear(img, torch.tensor([angle]))
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-3)
