"""Artifact writers (twin of unet_research_tpu/evaluation/artifacts.py;
reference utils_metrics.py:176-301).

Inputs are numpy HWC float [0, 1]. The `.pt` dumps are torch CPU tensors
in the reference's layouts (CHW, NCHW, KNCHW float32), which the density
analysis reads. The five figures are PNG rasters drawn with numpy and
written by utils/png.py, as the card's installation has no matplotlib:
the same file names and the same panels in the same order as the JAX
package's matplotlib figures, without axes, titles or colour bars.
"""

from __future__ import annotations

from os.path import join

import numpy as np
import torch

from unet_research_tpu_torch.evaluation.raster import colorize
from unet_research_tpu_torch.utils.general import to_u8
from unet_research_tpu_torch.utils.png import write_png

_GUTTER = 4  # white columns between the panels of a figure


def _chw(arr) -> np.ndarray:
    """HWC -> CHW for torch-format tensor dumps."""
    a = np.asarray(arr, dtype=np.float32)
    if a.ndim == 2:
        a = a[..., None]
    return np.moveaxis(a, -1, 0)


def save_tensor(arr, path: str) -> None:
    """torch.save of a (C, H, W) float32 tensor from HWC (the reference's
    segmentation dumps, utils_metrics.py:136)."""
    torch.save(torch.from_numpy(_chw(arr).copy()), path)


def save_tensor_batched(arr_nhwc, path: str) -> None:
    """torch.save of an (N, C, H, W) float32 tensor from NHWC: the engines'
    mean/std dumps, (1, 1, H, W) (Dropblock_Uncertainty.py:157-165)."""
    a = np.moveaxis(np.asarray(arr_nhwc, dtype=np.float32), -1, 1)
    torch.save(torch.from_numpy(a.copy()), path)


def save_stacked_tensors(arr_knhwc, path: str) -> None:
    """torch.save of a (K, N, C, H, W) float32 member stack from
    (K, N, H, W, C): the reference's tensors.pt."""
    a = np.moveaxis(np.asarray(arr_knhwc, dtype=np.float32), -1, 2)
    torch.save(torch.from_numpy(a.copy()), path)


def save_losses_as_text(train_losses, val_losses, save_path=".") -> None:
    np.array(train_losses, dtype=np.float64).tofile(
        join(save_path, "train_losses.txt"), sep="\n", format="%ls")
    np.array(val_losses, dtype=np.float64).tofile(
        join(save_path, "validation_losses.txt"), sep="\n", format="%ls")


def _panels(*images) -> np.ndarray:
    """uint8 panels of one height side by side, with white gutters."""
    h = images[0].shape[0]
    gutter = np.full((h, _GUTTER) + images[0].shape[2:], 255, np.uint8)
    parts = [images[0]]
    for im in images[1:]:
        parts += [gutter, im]
    return np.concatenate(parts, axis=1)


def _points(y0, x0, y1, x1):
    """The integer pixels of the segment (y0, x0) -> (y1, x1)."""
    n = int(max(abs(y1 - y0), abs(x1 - x0))) + 1
    return (np.rint(np.linspace(y0, y1, n)).astype(np.intp),
            np.rint(np.linspace(x0, x1, n)).astype(np.intp))


def save_loss_profile(train_losses, val_losses, save_path=".") -> None:
    """loss_profile.png, 800x500: the per-epoch train losses as a blue
    polyline and the validation losses as red triangles on white, both
    scaled to the finite values of the two series."""
    h, w = 500, 800
    img = np.full((h, w, 3), 255, np.uint8)
    series = [np.asarray(s, dtype=np.float64) for s in (train_losses, val_losses)]
    finite = np.concatenate([s[np.isfinite(s)] for s in series])
    if finite.size:
        margin = 40
        lo, hi = float(finite.min()), float(finite.max())
        count = max(len(s) for s in series)

        def place(i, v):
            x = margin + (w - 2 * margin) * (i / (count - 1) if count > 1 else 0.5)
            y = h - margin - (h - 2 * margin) * ((v - lo) / (hi - lo) if hi > lo else 0.5)
            return y, x

        train, val = series
        for i in range(len(train) - 1):
            if np.isfinite(train[i]) and np.isfinite(train[i + 1]):
                yy, xx = _points(*place(i, train[i]), *place(i + 1, train[i + 1]))
                for dy in (0, 1):
                    img[np.clip(yy + dy, 0, h - 1), xx] = (0, 0, 255)
        if len(train) == 1 and np.isfinite(train[0]):
            y, x = (int(round(c)) for c in place(0, train[0]))
            img[y - 1:y + 2, x - 1:x + 2] = (0, 0, 255)
        for i, v in enumerate(val):
            if np.isfinite(v):
                y, x = (int(round(c)) for c in place(i, v))
                for row in range(7):  # a filled triangle, apex up
                    img[y - 3 + row, x - row // 2:x + row // 2 + 1] = (255, 0, 0)
    write_png(join(save_path, "loss_profile.png"), img)


def save_contour_map(seg, gt, save_path=".") -> None:
    """The divergence 2(s - g) / max(|s| + |g|, 1e-6) of the thresholded
    segmentation s and gt g (utils_metrics.py:209-231), normalised to its
    min/max as imshow autoscales (all 0 when they are equal), in 'seismic'
    colours."""
    s = np.round(np.asarray(seg)[..., 0])
    g = np.asarray(gt)[..., 0]
    diff = 2 * (s - g) / np.clip(np.abs(s) + np.abs(g), 1e-6, None)
    write_png(join(save_path, "contour_map.png"), colorize(diff, "seismic"))


def save_overlap_map(seg, gt, save_path=".") -> None:
    """The thresholded segmentation in red at alpha 0.9 over the gray gt
    (utils_metrics.py:234-257)."""
    gray = to_u8(gt).astype(np.float64)[..., None].repeat(3, axis=-1)
    red = np.array([255.0, 0.0, 0.0])
    hit = (np.round(np.asarray(seg)[..., 0]) != 0)[..., None]
    out = np.where(hit, 0.9 * red + 0.1 * gray, gray)
    write_png(join(save_path, "overlap_map.png"), np.rint(out).astype(np.uint8))


def save_test_example(image, seg, id, save_path) -> None:
    """test_example_{id}.png: image | segmentation, in gray."""
    write_png(join(save_path, f"test_example_{id}.png"), _panels(to_u8(image), to_u8(seg)))


def save_segmentation(seg, id, save_path) -> None:
    """The thresholded segmentation as a 0/255 gray PNG
    (utils_metrics.py:277-279)."""
    write_png(join(save_path, f"{id}.png"), to_u8(np.round(np.asarray(seg))))


def save_val_example(image, seg, gt, id, save_path) -> None:
    """val_example_{id}.png: image | segmentation | thresholded
    segmentation | gt, in gray."""
    write_png(join(save_path, f"val_example_{id}.png"),
              _panels(to_u8(image), to_u8(seg), to_u8(np.round(np.asarray(seg))), to_u8(gt)))
