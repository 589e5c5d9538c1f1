"""The port's colour tables, rasters and PIL-style resize
(unet_research_tpu_torch/evaluation/raster.py) against matplotlib and PIL,
which the JAX package draws and resizes with.

Tolerances: the 'gray', 'jet' and 'seismic' tables and `colorize` bit-equal
to matplotlib's colormaps under Normalize (bytes=True), on values inside,
under and over the range, NaN included; the tab colours equal to
matplotlib.colors.to_rgb; `resize_bilinear_pil` within 2e-5 absolute of
PIL's float32 BILINEAR resize on 0-255 values (one float32 ulp at 255: the
taps are summed in another order)."""

import matplotlib

matplotlib.use("Agg")
import matplotlib.colors as mcolors  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from matplotlib.colors import Normalize  # noqa: E402
from PIL import Image  # noqa: E402

from unet_research_tpu_torch.evaluation import raster  # noqa: E402

CMAPS = ("gray", "jet", "seismic")


@pytest.mark.parametrize("name", CMAPS)
def test_luts_are_matplotlibs(name):
    cmap = matplotlib.colormaps[name]
    want = cmap(np.arange(256), bytes=True)[:, :3]
    np.testing.assert_array_equal(raster.LUTS[name], want)
    assert raster.LUTS[name].dtype == np.uint8


@pytest.mark.parametrize("name", CMAPS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("limits", [(0, 1), (0.0, 0.7), (-0.5, 0.5), (0, 5.0), (None, None),
                                    (0.25, 0.25), (0, np.float32(0.2912))])
def test_colorize_is_matplotlibs(name, dtype, limits):
    rng = np.random.default_rng(1)
    x = (rng.random((40, 30)) * 1.6 - 0.3).astype(dtype)
    x[0, :4] = (0.0, 1.0, -0.5, 0.5)  # the ends and exact edges
    vmin, vmax = limits
    want = matplotlib.colormaps[name](Normalize(vmin, vmax)(x), bytes=True)[..., :3]
    np.testing.assert_array_equal(raster.colorize(x, name, vmin, vmax), want)
    x[1, 1] = np.nan
    want = matplotlib.colormaps[name](Normalize(vmin, vmax)(x), bytes=True)[..., :3]
    np.testing.assert_array_equal(raster.colorize(x, name, vmin, vmax), want)


def test_colorize_uint8_autoscaled_is_matplotlibs():
    u8 = np.random.default_rng(2).integers(3, 250, (24, 20)).astype(np.uint8)
    want = matplotlib.colormaps["gray"](Normalize()(u8), bytes=True)[..., :3]
    np.testing.assert_array_equal(raster.colorize(u8), want)


def test_tab_colours_are_matplotlibs():
    for name, rgb in raster.TAB.items():
        assert rgb == mcolors.to_rgb(name)


@pytest.mark.parametrize("src,dst", [((584, 565), (256, 256)), ((256, 256), (584, 565)),
                                     ((584, 565), (128, 128)), ((128, 128), (584, 565)),
                                     ((24, 20), (16, 16))])
def test_resize_bilinear_is_pils(src, dst):
    a = (np.random.default_rng(src[1] + dst[0]).random(src) * 255).astype(np.float32)
    want = np.array(Image.fromarray(a).resize((dst[1], dst[0]), Image.BILINEAR), np.float32)
    got = raster.resize_bilinear_pil(a, dst)
    assert got.dtype == np.float32 and got.shape == dst
    assert np.abs(got - want).max() <= 2e-5


def test_resize_bilinear_one_axis():
    a = (np.random.default_rng(4).random((24, 20)) * 255).astype(np.float32)
    for dst in ((24, 16), (16, 20)):
        want = np.array(Image.fromarray(a).resize((dst[1], dst[0]), Image.BILINEAR), np.float32)
        assert np.abs(raster.resize_bilinear_pil(a, dst) - want).max() <= 2e-5


@pytest.mark.parametrize("style", ["-", ":", "--", "-."])
def test_plot_curves_draws_each_style(style):
    xs = np.linspace(0, 0.5, 1000)
    ys = np.exp(-((xs - 0.2) ** 2) / 0.002)
    img = raster.plot_curves([(xs, ys, style, raster.TAB["tab:red"], 0.6)], (0, 0.5))
    assert img.shape == (1000, 1500, 3) and img.dtype == np.uint8
    drawn = (img != 255).any(-1)
    # one blend of tab:red at alpha 0.6 over white
    want = np.rint(0.4 * 255 + 0.6 * np.array(raster.TAB["tab:red"]) * 255)
    np.testing.assert_array_equal(np.unique(img[drawn], axis=0), want[None].astype(np.uint8))
    cols = np.flatnonzero(drawn.any(0))
    # the curve spans the subplot box's width, 5% margins inside it
    assert abs(cols[0] - 1500 * (0.125 + 0.775 / 22)) <= 3
    assert abs(cols[-1] - 1500 * (0.9 - 0.775 / 22)) <= 3
    if style != "-":
        gaps = np.diff(cols)
        assert gaps.max() > 1  # the dashes leave gaps
    else:
        assert (np.diff(cols) == 1).all()


def test_plot_bars_fills_the_histogram():
    counts, edges = np.histogram(np.random.default_rng(5).random(1000) * 0.4, bins="auto",
                                 range=(0, 0.5), density=True)
    img = raster.plot_bars(counts, edges)
    assert img.shape == (480, 640, 3)
    blue = (img == np.rint(np.array(raster.TAB["tab:blue"]) * 255).astype(np.uint8)).all(-1)
    assert blue.any() and ((img == 255).all(-1) | blue).all()
    # the empty bins past 0.4 draw nothing
    rows = np.flatnonzero(blue.any(1))
    assert rows[-1] <= int(np.ceil(480 * (1 - 0.11)))
