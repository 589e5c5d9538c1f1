"""Colour tables, rasters and the image helpers of the analysis, in numpy on
the host (the JAX package draws with matplotlib and resizes with cv2 and
PIL; the card's installation has neither matplotlib nor cv2, and the port
depends on numpy, torch and the standard library only).

- LUTS: matplotlib's 256-entry 'gray', 'jet' and 'seismic' tables in bytes,
  built from its segment data as LinearSegmentedColormap builds them;
  `colorize` maps values through them with matplotlib's Normalize and index
  rules, bit for bit.
- TAB: the tab10 colours the density figures name ('tab:blue' ...).
- `plot_curves` and `plot_bars`: the KDE curves (solid, ':', '--', '-.')
  and histogram bars on a white canvas of the JAX figure's pixel size. As
  the figures of artifacts.py, they carry no axes, titles, legends or
  colour bars.
- `resize_nearest_cv2`, `erode3x3` and `resize_bilinear_pil`: cv2's
  INTER_NEAREST resize, cv2's 3x3 erode and PIL's float32 BILINEAR resize.
"""

from __future__ import annotations

import numpy as np

_N = 256
_DPI = 100  # matplotlib's figure.dpi: a (15, 10) inch figure is 1500x1000 pixels
_LINEWIDTH = 1.5  # the density figures' curves


def _segment_lut(data) -> np.ndarray:
    """One channel of a LinearSegmentedColormap: rows (x, y0, y1) sampled
    at N points (matplotlib.colors._create_lookup_table, gamma 1)."""
    adata = np.array(data, dtype=np.float64)
    x, y0, y1 = adata[:, 0] * (_N - 1), adata[:, 1], adata[:, 2]
    xind = (_N - 1) * np.linspace(0, 1, _N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _table(segments: dict) -> np.ndarray:
    """(256, 3) uint8: the float table times 255, truncated, as
    Colormap(..., bytes=True) gives it."""
    lut = np.stack([_segment_lut(segments[ch]) for ch in ("red", "green", "blue")], axis=-1)
    return (lut * 255).astype(np.uint8)


def _from_list(colors) -> dict:
    """LinearSegmentedColormap.from_list's segment data: colours at even
    steps."""
    vals = np.linspace(0, 1, len(colors))
    chans = np.array(colors, dtype=np.float64).T
    return {name: np.column_stack([vals, c, c]) for name, c in zip(("red", "green", "blue"), chans)}


# matplotlib/_cm.py: _gray_data, _jet_data, _seismic_data
_GRAY_DATA = {ch: ((0.0, 0, 0), (1.0, 1, 1)) for ch in ("red", "green", "blue")}
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
_SEISMIC_DATA = ((0.0, 0.0, 0.3), (0.0, 0.0, 1.0), (1.0, 1.0, 1.0), (1.0, 0.0, 0.0),
                 (0.5, 0.0, 0.0))
LUTS = {"gray": _table(_GRAY_DATA), "jet": _table(_JET_DATA),
        "seismic": _table(_from_list(_SEISMIC_DATA))}

# matplotlib's TABLEAU_COLORS, as matplotlib.colors.to_rgb gives them
_TAB_HEX = {"tab:blue": "1f77b4", "tab:orange": "ff7f0e", "tab:green": "2ca02c",
            "tab:red": "d62728", "tab:purple": "9467bd", "tab:brown": "8c564b"}
TAB = {name: tuple(int(h[i:i + 2], 16) / 255 for i in (0, 2, 4)) for name, h in _TAB_HEX.items()}


def colorize(arr, cmap: str = "gray", vmin=None, vmax=None) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 through a 256-entry table, as
    `matplotlib.colormaps[cmap](Normalize(vmin, vmax)(arr), bytes=True)`:
    the normalisation in float64 rounded to the input's float type (float32
    for integer input), x * 256 with 256 -> 255, truncation, values under
    and over the range to the end colours, NaN black. A missing vmin or
    vmax is the data's min or max in its own type; vmin == vmax maps
    everything to 0."""
    a = np.asarray(arr)
    ftype = a.dtype if a.dtype.kind == "f" else np.dtype(np.float32)
    x = np.array(a, dtype=ftype)
    # a given limit is a float64 scalar, a missing one the data's own
    # (NaN when the data holds one, as matplotlib's autoscale gives it)
    lo = x.min() if vmin is None else np.float64(vmin)
    hi = x.max() if vmax is None else np.float64(vmax)
    if lo == hi:
        x.fill(0)
    elif lo > hi:
        raise ValueError("vmin must be less than or equal to vmax")
    else:
        x -= lo
        x /= hi - lo
    x *= _N
    x[x == _N] = _N - 1
    under, over, bad = x < 0, x >= _N, np.isnan(x)
    with np.errstate(invalid="ignore"):
        index = x.astype(int)
    index[under] = 0
    index[over] = _N - 1
    index[bad] = 0
    out = LUTS[cmap][index]
    out[bad] = 0
    return out


# --- plots -------------------------------------------------------------------

# matplotlib's subplot box (figure.subplot.left/right/bottom/top)
_BOX = (0.125, 0.9, 0.11, 0.88)
_CURVES_IN, _BARS_IN = (15, 10), (6.4, 4.8)  # the JAX figures' sizes, inches
# rcParams lines.*_pattern, in points per unit of line width
_DASHES = {"-": None, "--": (3.7, 1.6), "-.": (6.4, 1.6, 1.0, 1.6), ":": (1.0, 1.65)}


def _frame(size_in, xlim, ylim):
    """A white canvas of the figure's pixel size and the map from data
    coordinates to (row, column) inside matplotlib's subplot box."""
    w, h = int(round(size_in[0] * _DPI)), int(round(size_in[1] * _DPI))
    img = np.full((h, w, 3), 255, np.uint8)
    left, right, bottom, top = _BOX
    (x0, x1), (y0, y1) = xlim, ylim

    def place(x, y):
        fx = (np.asarray(x, np.float64) - x0) / (x1 - x0) if x1 > x0 else 0.5
        fy = (np.asarray(y, np.float64) - y0) / (y1 - y0) if y1 > y0 else 0.5
        return (1.0 - (bottom + fy * (top - bottom))) * h, (left + fx * (right - left)) * w

    return img, place


def _margins(lo: float, hi: float) -> tuple:
    """matplotlib's default 5% axis margins."""
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


def _stroke(shape, rows, cols, style: str) -> np.ndarray:
    """Boolean coverage of a polyline through (rows, cols) in pixels, in one
    of matplotlib's line styles: dashes measured along the line in points
    scaled by the line width, a square pen of the line's width."""
    h, w = shape
    width = max(1, int(round(_LINEWIDTH * _DPI / 72)))
    cover = np.zeros((h, w), bool)
    if len(rows) < 2:
        return cover
    seg = np.hypot(np.diff(rows), np.diff(cols))
    n = np.maximum(1, np.ceil(seg * 2).astype(np.intp))  # samples every <= 0.5 px
    starts = np.concatenate([[0.0], np.cumsum(seg)])
    k = np.repeat(np.arange(len(seg)), n)
    t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(n, n)
    r = rows[k] + t * np.diff(rows)[k]
    c = cols[k] + t * np.diff(cols)[k]
    s = starts[k] + t * seg[k]
    pattern = _DASHES[style]
    if pattern is not None:
        lengths = np.array(pattern) * _LINEWIDTH * _DPI / 72
        phase = np.mod(s, lengths.sum())
        on = np.zeros(len(s), bool)
        edge = 0.0
        for i, length in enumerate(lengths):
            if i % 2 == 0:
                on |= (phase >= edge) & (phase < edge + length)
            edge += length
        r, c = r[on], c[on]
    base_r = np.floor(r - (width - 1) / 2).astype(np.intp)
    base_c = np.floor(c - (width - 1) / 2).astype(np.intp)
    for dr in range(width):
        for dc in range(width):
            rr, cc = base_r + dr, base_c + dc
            keep = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
            cover[rr[keep], cc[keep]] = True
    return cover


def plot_curves(curves, xlim) -> np.ndarray:
    """(1000, 1500, 3) uint8: each curve (xs, ys, style, rgb, alpha) drawn
    in order over white, alpha-blended once per curve (with no curve, a
    white figure, as matplotlib saves an empty one). x spans `xlim`, y the
    curves' own range, both with matplotlib's 5% margins."""
    ys = [np.asarray(c[1], np.float64) for c in curves]
    ylim = (min(y.min() for y in ys), max(y.max() for y in ys)) if ys else (0.0, 1.0)
    img, place = _frame(_CURVES_IN, _margins(*xlim), _margins(*ylim))
    for x, y, style, rgb, alpha in curves:
        rows, cols = place(x, y)
        cover = _stroke(img.shape[:2], rows, cols, style)
        colour = np.array(rgb, np.float64) * 255
        img[cover] = np.rint((1 - alpha) * img[cover] + alpha * colour).astype(np.uint8)
    return img


def plot_bars(heights, edges) -> np.ndarray:
    """(480, 640, 3) uint8: histogram bars in ax.hist's default colour
    (tab:blue) from 0 to each height between consecutive edges; y from 0
    with a 5% top margin, x over the edges with 5% margins."""
    heights = np.asarray(heights, np.float64)
    edges = np.asarray(edges, np.float64)
    top = float(heights.max()) if heights.size and np.isfinite(heights).all() else 0.0
    img, place = _frame(_BARS_IN, _margins(float(edges[0]), float(edges[-1])),
                        (0.0, top * 1.05 if top > 0 else 1.0))
    colour = np.rint(np.array(TAB["tab:blue"]) * 255)
    base, _ = place(edges[0], 0.0)
    _, cols = place(edges, np.zeros_like(edges))
    rows, _ = place(edges[:-1], heights)
    h, w = img.shape[:2]
    for i, height in enumerate(heights):
        if not height > 0:
            continue
        c0, c1 = int(np.floor(cols[i])), max(int(np.floor(cols[i + 1])), int(np.floor(cols[i])) + 1)
        r0 = int(np.floor(rows[i]))
        img[max(0, r0):min(h, int(np.ceil(base))), max(0, c0):min(w, c1)] = colour
    return img


# --- image helpers in place of cv2 and PIL ----------------------------------

def resize_nearest_cv2(arr, hw) -> np.ndarray:
    """cv2.resize(arr, (w, h), interpolation=cv2.INTER_NEAREST): source
    index min(floor(x * (1 / (dst / src))), src - 1) in float64."""
    a = np.asarray(arr)
    (sh, sw), (dh, dw) = a.shape[:2], hw

    def taps(src, dst):
        scale = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * scale).astype(np.intp), src - 1)

    return a[taps(sh, dh)[:, None], taps(sw, dw)[None, :]]


def erode3x3(u8) -> np.ndarray:
    """cv2.erode(u8, np.ones((3, 3))): the 3x3 minimum, the border padded
    with 255 (cv2's default erode border value is the maximum, so the
    border erodes nothing)."""
    a = np.asarray(u8, np.uint8)
    p = np.pad(a, 1, constant_values=255)
    h, w = a.shape
    out = p[1:h + 1, 1:w + 1].copy()
    for dy in range(3):
        for dx in range(3):
            np.minimum(out, p[dy:dy + h, dx:dx + w], out=out)
    return out


def _pil_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs for the triangle (BILINEAR) filter: per
    output index its first tap and float64 weights normalised to sum 1."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.intp)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = np.maximum(0.0, 1.0 - np.abs((np.arange(xmax) + xmin - center + 0.5) / filterscale))
        total = k.sum()
        weights[xx, :xmax] = k / total if total != 0.0 else k
        first[xx] = xmin
    return first, weights


def _pil_pass(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass along `axis`, the taps summed in order in float64
    and stored as float32, as PIL's 32-bit float resampler does."""
    a = np.moveaxis(a, axis, -1)
    first, weights = _pil_coeffs(a.shape[-1], out_size)
    acc = np.zeros(a.shape[:-1] + (out_size,), np.float64)
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, a.shape[-1] - 1)
        acc += a[..., idx].astype(np.float64) * weights[:, t]
    return np.moveaxis(acc.astype(np.float32), -1, axis)


def resize_bilinear_pil(arr, hw) -> np.ndarray:
    """Image.fromarray(float32).resize((w, h), Image.BILINEAR) as a float32
    array: the horizontal pass first, then the vertical; an axis whose size
    does not change is not resampled."""
    out = np.asarray(arr, np.float32)
    if out.shape[1] != hw[1]:
        out = _pil_pass(out, hw[1], 1)
    if out.shape[0] != hw[0]:
        out = _pil_pass(out, hw[0], 0)
    return out
