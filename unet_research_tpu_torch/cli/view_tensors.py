"""Static tensor viewer (twin of unet_research_tpu/cli/view_tensors.py):
the reference's Evaluate_Tensors.ipynb panels as PNG contact sheets.

Per model and validation image, `{model}_image_{i}.png`: the input, then for
the DB and ROT ensembles the mean (gray, 0-1), the std (jet, 0 to its max)
and the CV map (std/mean inside the FOV; jet, 0-5 for DB and 0-2 for ROT),
the independent - dependent mean difference when both MC runs exist
(seismic, -0.5-0.5) and the ground truth. Plus the notebook's "MSE over
Base model" section, `MSE_Plot_{model}.png`: the validation image with the
highest plain-segmentation MSE of the first model that has one, and for
every model the squared error against the ground truth of its plain
segmentation, DB mean and ROT mean (jet, 0-1).

As in the JAX package this is host code. Each panel is colourised at its
tensor's own resolution with matplotlib's colour tables and index rule
(evaluation/raster.py) and the panels stand side by side; the sheets have
no titles, axes or colour bars.

Usage:
  python -m unet_research_tpu_torch.cli.view_tensors -results_root RUNS \
      -aug_root AUG -save_path RUNS/viewer [-models BM-1,MF-1]
"""

from __future__ import annotations

import argparse
import os
from os.path import exists, join

import numpy as np

from unet_research_tpu_torch.evaluation.density import MODELS, extract_tensors
from unet_research_tpu_torch.evaluation.raster import colorize, resize_bilinear_pil
from unet_research_tpu_torch.utils.png import read_png, write_png

_GUTTER = 4  # white columns between panels


def _load_val_images(aug_root):
    out = {}
    for sub in ("images", "targets", "masks"):
        d = join(aug_root, "val", sub)
        out[sub] = {}
        if exists(d):
            for f in os.listdir(d):
                out[sub][int(f.split("_")[0])] = read_png(join(d, f))
    return out


def _resize_to(arr, hw):
    """Bilinear resize of a 2-D array to (H, W) as PIL resizes a float32
    image (the notebook's TF.resize of the GT, Evaluate_Tensors.ipynb cell
    96)."""
    if arr.shape == tuple(hw):
        return np.asarray(arr, np.float32)
    return resize_bilinear_pil(arr, hw)


def _cv_map(mean2d, std2d, fov):
    """std/mean coefficient-of-variation inside the FOV, 0 elsewhere (the
    per-pixel quantity behind the notebook's CV histograms, cells 65-76)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        cv = std2d / mean2d
    cv = np.nan_to_num(cv, nan=0.0, posinf=0.0, neginf=0.0)
    if fov is not None:
        cv = cv * (fov > 0.5)
    return cv


def _panel(arr, cmap="gray", vmin=None, vmax=None) -> np.ndarray:
    """One panel: `arr` through the colour table at its own resolution."""
    return colorize(arr, cmap, vmin, vmax)


def _sheet(panels) -> np.ndarray:
    """Panels side by side with white gutters, each on a white ground of
    the tallest panel's height."""
    h = max(p.shape[0] for p in panels)
    parts = []
    for p in panels:
        if parts:
            parts.append(np.full((h, _GUTTER, 3), 255, np.uint8))
        parts.append(np.pad(p, ((0, h - p.shape[0]), (0, 0), (0, 0)), constant_values=255))
    return np.concatenate(parts, axis=1)


def _blank(hw) -> np.ndarray:
    return np.full(tuple(hw) + (3,), 255, np.uint8)


def render_model(model, results_root, val_data, save_dir):
    sources = {
        "DB": join(results_root, model, "dropblock_uncertainty", "tensors"),
        "ROT": join(results_root, model, "rotation_uncertainty"),
    }
    means = {k: extract_tensors(p, "mean.pt") for k, p in sources.items()}
    stds = {k: extract_tensors(p, "std.pt") for k, p in sources.items()}
    dep_means = extract_tensors(
        join(results_root, model, "dropblock_uncertainty_dep", "tensors"), "mean.pt"
    )

    images = sorted(set().union(*[set(m) for m in means.values()]))
    if not images:
        return 0
    os.makedirs(save_dir, exist_ok=True)
    # CV display ranges follow the notebook's histogram ranges: (0,5) for
    # DB, (0,2) for ROT (Evaluate_Tensors.ipynb cell 76)
    cv_vmax = {"DB": 5.0, "ROT": 2.0}
    for i in images:
        panels = []
        tensor_hw = next(means[k][i][0, 0].shape for k in sources if i in means[k])
        if i in val_data["images"]:
            panels.append(_panel(val_data["images"][i]))
        else:
            panels.append(_blank(tensor_hw))
        for kind in ("DB", "ROT"):
            if i in means[kind]:
                mm = means[kind][i][0, 0]
                panels.append(_panel(mm, vmin=0, vmax=1))
                sm = stds[kind][i][0, 0]
                panels.append(_panel(sm, "jet", vmin=0, vmax=max(1e-6, sm.max())))
                fov = val_data["masks"].get(i)
                if fov is not None:
                    fov = _resize_to(fov, mm.shape)
                cv = _cv_map(mm, sm, fov)
                panels.append(_panel(cv, "jet", vmin=0, vmax=cv_vmax[kind]))
        if i in dep_means and i in means["DB"]:
            a, b = means["DB"][i][0, 0], dep_means[i][0, 0]
            hw = (min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1]))
            diff = a[: hw[0], : hw[1]] - b[: hw[0], : hw[1]]
            panels.append(_panel(diff, "seismic", vmin=-0.5, vmax=0.5))
        if i in val_data["targets"]:
            panels.append(_panel(val_data["targets"][i]))
        else:
            panels.append(_blank(tensor_hw))
        write_png(join(save_dir, f"{model}_image_{i}.png"), _sheet(panels))
    return len(images)


def _load_plain_segs(results_root, model):
    """Plain (non-MC) validation segmentations from the model's test run:
    {image_id: (H, W) float}. Falls back to the training run's copy."""
    for stats in ("test_statistics", "statistics"):
        d = join(results_root, model, stats, "val_images", "tensors")
        segs = extract_tensors(d, "segmentation.pt")
        if segs:
            return {i: np.asarray(t).reshape(t.shape[-2:]) for i, t in segs.items()}
    return {}


def render_mse_panels(models, results_root, val_data, save_dir):
    """The notebook's 'MSE over Base model' section (Evaluate_Tensors.ipynb
    cells 92-96): select the val image with the highest base-model plain-seg
    MSE vs ground truth (printed on a line of its own), then render
    per-pixel squared-error maps vs GT for every model's plain
    segmentation, DB mean, and ROT mean."""
    targets = val_data["targets"]
    if not targets:
        return 0
    base = next((m for m in models if _load_plain_segs(results_root, m)), None)
    if base is None:
        return 0
    base_segs = _load_plain_segs(results_root, base)

    def gt_for(i, hw):
        return _resize_to(targets[i], hw) / 255.0

    # worst image by base-model MSE (notebook cell 94 uses BM-1; the first
    # model with plain segs is used so partial matrices still render)
    cur_i, real_max = None, -1.0
    for i, seg in base_segs.items():
        if i not in targets:
            continue
        mse = float(np.mean((seg - gt_for(i, seg.shape)) ** 2))
        if mse > real_max:
            cur_i, real_max = i, mse
    if cur_i is None:
        return 0
    print(f"[view_tensors] worst image for {base}: {cur_i} mse {real_max!r}")

    os.makedirs(save_dir, exist_ok=True)
    rendered = 0
    for model in models:
        panels = []
        segs = _load_plain_segs(results_root, model)
        if cur_i in segs:
            panels.append(segs[cur_i])
        db = extract_tensors(
            join(results_root, model, "dropblock_uncertainty", "tensors"), "mean.pt"
        )
        if cur_i in db:
            panels.append(db[cur_i][0, 0])
        rot = extract_tensors(
            join(results_root, model, "rotation_uncertainty"), "mean.pt"
        )
        if cur_i in rot:
            panels.append(rot[cur_i][0, 0])
        if not panels:
            continue
        errs = [(np.asarray(seg, np.float32) - gt_for(cur_i, seg.shape)) ** 2 for seg in panels]
        write_png(join(save_dir, f"MSE_Plot_{model}.png"),
                  _sheet([_panel(err, "jet", vmin=0, vmax=1) for err in errs]))
        rendered += 1
    return rendered


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-results_root", dest="results_root", required=True)
    parser.add_argument("-aug_root", dest="aug_root", required=True)
    parser.add_argument("-save_path", dest="save_path", required=True)
    parser.add_argument("-models", dest="models", default=",".join(MODELS))
    args, _ = parser.parse_known_args(argv)

    val_data = _load_val_images(args.aug_root)
    total = 0
    model_list = [m for m in args.models.split(",") if m]
    for model in model_list:
        total += render_model(model, args.results_root, val_data, args.save_path)
    total += render_mse_panels(model_list, args.results_root, val_data, args.save_path)
    print(f"rendered {total} panels to {args.save_path}")
    return args.save_path


if __name__ == "__main__":
    main()
