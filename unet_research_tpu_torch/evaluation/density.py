"""Offline density analysis of saved uncertainty tensors (twin of
unet_research_tpu/evaluation/density.py; the reference's
create_density_{STD,CV,DID}.py).

- extract_tensors: the tensors/image_{i}/{mean,std}.pt dumps;
- std_density / std_single_density / cv_density and the dependent-vs-
  independent overlay: Gaussian KDE curves (bandwidth range/num_steps) of
  thresholded per-pixel STDs and of the FOV coefficient of variation;
- calculate_magnitudes: the per-model/per-image STD summary table;
- hist_battery: the FOV CV histogram and the dilated / inverse-dilated
  vessel-region STD and CV histograms.

The JAX package fits sklearn's KernelDensity on the host; here `_kde_curve`
evaluates the same sum in float64 on `device` (the card by default), in
blocks of bounded size. The selections (thresholds, the CV range filter,
np.isfinite), the histograms (`np.histogram(..., bins="auto")`) and the
magnitudes (numpy's float32 reductions) run in numpy on the same float32
arrays as in the JAX package, so they give the same numbers. The CSVs are
written as pandas' `to_csv(index=False)` writes them, the figures as numpy
rasters (evaluation/raster.py) with the JAX files' names, without axes,
titles or legends.

The directory layout consumed is what the CLIs write:
<root>/<model>/statistics/val_images/metrics.csv,
<root>/<model>/dropblock_uncertainty/tensors/image_{i}/{mean,std}.pt,
<root>/<model>/dropblock_uncertainty_dep/tensors/image_{i}/{mean,std}.pt and
<root>/<model>/rotation_uncertainty/image_{i}/{mean,std}.pt.
"""

from __future__ import annotations

import csv
import math
import os
from os.path import exists, join

import numpy as np
import torch

from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.evaluation.raster import (
    TAB,
    erode3x3,
    plot_bars,
    plot_curves,
    resize_nearest_cv2,
)
from unet_research_tpu_torch.utils.png import read_png, write_png

MODELS = "BM-1 BM-2 BM-3 MF-1 MF-2 MF-3 LF-1 LF-3 LF-5 LF-2 LF-4 LF-6".split()
GROUPS = {
    "All Model": MODELS,
    "Base Model": ["BM-1", "BM-2", "BM-3"],
    "Multi Fidelity Model": ["MF-1", "MF-2", "MF-3"],
    "LF HFT Model": ["LF-1", "LF-3", "LF-5"],
    "LF LFT Model": ["LF-2", "LF-4", "LF-6"],
}
COLORSCHEME = {
    "BM-1": "tab:blue", "BM-2": "tab:blue", "BM-3": "tab:blue",
    "LF-1": "tab:orange", "LF-3": "tab:orange", "LF-5": "tab:orange",
    "LF-2": "tab:green", "LF-4": "tab:green", "LF-6": "tab:green",
    "MF-1": "tab:red", "MF-2": "tab:red", "MF-3": "tab:red",
}
MARKERSCHEME = {
    "BM-1": "-", "BM-2": ":", "BM-3": "--", "LF-1": "-.", "LF-3": ":",
    "LF-5": "--", "LF-2": "-", "LF-4": ":", "LF-6": "--", "MF-1": "-",
    "MF-2": ":", "MF-3": "--",
}
IM_COLORS = {i: c for i, c in enumerate(
    ["tab:blue", "tab:orange", "tab:green", "tab:red", "tab:purple", "tab:brown"])}
# the start of matplotlib's default colour cycle, for the two curves the
# dependent-vs-independent overlay draws without a colour
_CYCLE = ("tab:blue", "tab:orange")

# The KDE's blocks. A term more than 39 bandwidths from its grid point is
# exp(-760.5) or less, which is 0 in float64, so a block of sorted values
# needs only the grid points within 39 bandwidths of its range: the sum is
# the dense one, less terms that are exactly 0. A block holds at most
# _KDE_BLOCK (value, grid point) terms (128 MiB of float64); at most
# _KDE_UPLOAD values are on the device at once (sorted with their indices,
# 224 MiB), so the extra device memory stays under 1 GiB for any N.
_KDE_REACH = 39.0
_KDE_BLOCK = 1 << 24
_KDE_UPLOAD = 1 << 23


def extract_tensors(path: str, tensor_name: str) -> dict:
    """Load {image_i -> tensor} numpy arrays from an uncertainty output dir,
    in os.listdir order."""
    out = {}
    if not exists(path):
        return out
    for sub in os.listdir(path):
        if sub.startswith("image"):
            tp = join(path, sub, tensor_name)
            if exists(tp):
                out[int(sub.split("_")[-1])] = torch.load(tp, map_location="cpu").numpy()
    return out


def _kde_curve(data: np.ndarray, rnge, num_steps: int, device=None):
    """The Gaussian KDE of `data` with bandwidth h = (r1 - r0) / num_steps at
    np.linspace(r0, r1, num_steps), as sklearn's KernelDensity gives it:
    p(x) = sum_i exp(-(x - x_i)^2 / 2h^2) / (N h sqrt(2 pi)), in float64 on
    `device`. Returns (xs, density) as numpy float64."""
    dev = resolve_device(device)
    r0, r1 = rnge
    bandwidth = (r1 - r0) / num_steps
    xs = np.linspace(r0, r1, num_steps)
    grid = torch.from_numpy(xs).to(dev)
    total = torch.zeros(num_steps, dtype=torch.float64, device=dev)
    flat = np.ascontiguousarray(data).reshape(-1)
    rows = max(1, _KDE_BLOCK // num_steps)
    reach = _KDE_REACH * bandwidth
    scale = -0.5 / (bandwidth * bandwidth)
    for start in range(0, flat.size, _KDE_UPLOAD):
        vals = torch.from_numpy(flat[start:start + _KDE_UPLOAD]).to(dev)
        vals = vals.to(torch.float64).sort().values
        # each block's first and last value bound its grid window
        ends = torch.arange(rows - 1, vals.numel() + rows - 1, rows, device=dev)
        bounds = torch.stack([
            torch.searchsorted(grid, vals[::rows] - reach),
            torch.searchsorted(grid, vals[ends.clamp(max=vals.numel() - 1)] + reach, right=True),
        ]).tolist()
        for b, (j0, j1) in enumerate(zip(*bounds)):
            if j1 > j0:
                d = grid[j0:j1] - vals[b * rows:(b + 1) * rows, None]
                total[j0:j1] += d.square_().mul_(scale).exp_().sum(0)
    density = total.cpu().numpy() / (flat.size * bandwidth * math.sqrt(2 * math.pi))
    return xs, density


def _figure_path(save_path: str, figname: str) -> str:
    return join(save_path, f"{'_'.join(figname.split(' '))}.png")


def std_density(models, std_data, threshold, rnge, num_steps, figname,
                xlabel, ylabel, save_path, device=None):
    """Overlay per-model KDE curves of thresholded per-pixel STDs."""
    curves = []
    for model in models:
        if model not in std_data or not std_data[model]:
            continue
        data = np.concatenate([v.flatten() for v in std_data[model].values()])
        data = data[data > threshold]
        if data.size < 2:
            continue
        xs, dens = _kde_curve(data, rnge, num_steps, device)
        curves.append((xs, dens, MARKERSCHEME.get(model, "-"),
                       TAB[COLORSCHEME.get(model, "tab:blue")], 0.6))
    os.makedirs(save_path, exist_ok=True)
    write_png(_figure_path(save_path, figname), plot_curves(curves, rnge))


def std_single_density(model, std_data, threshold, rnge, num_steps, figname,
                       xlabel, ylabel, save_path, device=None):
    """Per-image KDE curves for one model (create_density_STD.py:489-523)."""
    curves = []
    for im, data in sorted(std_data.get(model, {}).items()):
        data = data.flatten()
        data = data[data > threshold]
        if data.size < 2:
            continue
        xs, dens = _kde_curve(data, rnge, num_steps, device)
        curves.append((xs, dens, "-", TAB[IM_COLORS[im % 6]], 0.6))
    os.makedirs(save_path, exist_ok=True)
    write_png(_figure_path(save_path, figname), plot_curves(curves, rnge))


def _fov_values(arr2d: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Values inside the FOV, with the mask resized (nearest, as cv2) to the
    tensor resolution (uncertainty runs may be at a resize)."""
    m = mask
    if m.shape != arr2d.shape:
        m = resize_nearest_cv2(m.astype(np.uint8), arr2d.shape)
    return arr2d[m > 0]


def _cv_values(std, mean, mask):
    """std/mean over the FOV (all pixels without a mask), 0/0 and x/0
    included."""
    s, m = std[0, 0], mean[0, 0]
    if mask is not None:
        s, m = _fov_values(s, mask), _fov_values(m, mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        return s / m


def cv_density(models, std_data, mean_data, masks, rnge, num_steps, figname,
               save_path, device=None):
    """KDE of the coefficient of variation std/mean over FOV pixels
    (create_density_CV.py cv_density)."""
    curves = []
    for model in models:
        if model not in std_data or not std_data[model]:
            continue
        cvs = []
        for i, std in std_data[model].items():
            if i not in mean_data.get(model, {}):
                continue
            cv = _cv_values(std, mean_data[model][i], masks[i] if masks and i in masks else None)
            cvs.append(cv[np.isfinite(cv)])
        if not cvs:
            continue
        data = np.concatenate(cvs)
        data = data[(data >= rnge[0]) & (data <= rnge[1])]
        if data.size < 2:
            continue
        xs, dens = _kde_curve(data, rnge, num_steps, device)
        curves.append((xs, dens, MARKERSCHEME.get(model, "-"),
                       TAB[COLORSCHEME.get(model, "tab:blue")], 0.6))
    os.makedirs(save_path, exist_ok=True)
    write_png(_figure_path(save_path, figname), plot_curves(curves, rnge))


MAGNITUDE_COLUMNS = ["model_name", "im_num", "min", "max", "mean", "std"] + [
    f"{stat}_thresholded_{thr:g}" for thr in (0.01, 0.001, 0.0) for stat in ("mean", "std")]


def calculate_magnitudes(std_dicts: dict) -> list:
    """Per-model/per-image STD summary rows (create_density_STD.py:99-138),
    dicts in MAGNITUDE_COLUMNS order, from numpy's float32 reductions."""
    rows = []
    for model_name, model_dict in std_dicts.items():
        for im_num, t in model_dict.items():
            flat = t.flatten()
            row = {
                "model_name": model_name, "im_num": im_num,
                "min": float(flat.min()), "max": float(flat.max()),
                "mean": float(flat.mean()), "std": float(flat.std(ddof=1)),
            }
            for thr in (0.01, 0.001, 0.0):
                sel = flat[flat > thr]
                row[f"mean_thresholded_{thr:g}"] = float(sel.mean()) if sel.size else float("nan")
                row[f"std_thresholded_{thr:g}"] = float(sel.std(ddof=1)) if sel.size > 1 else float("nan")
            rows.append(row)
    return rows


# --- CSV tables as pandas reads and writes them ------------------------------

def _parse_column(fields: list) -> list:
    """One column as read_csv types it: all integers -> int; numbers or
    empty fields -> float, empty as NaN; otherwise strings, empty as NaN."""
    nan = float("nan")
    if fields and all(f != "" for f in fields):
        try:
            return [int(f) for f in fields]
        except ValueError:
            pass
    try:
        return [nan if f == "" else float(f) for f in fields]
    except ValueError:
        return [nan if f == "" else f for f in fields]


def read_table(path: str) -> dict:
    """A CSV file as {column: values}, typed per column as read_csv does."""
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f))
    return {name: _parse_column([row[j] for row in body]) for j, name in enumerate(header)}


def concat_tables(tables: list) -> dict:
    """pd.concat: the union of the columns in first-seen order, missing cells
    NaN; an integer column with a missing cell becomes float."""
    columns = []
    for t in tables:
        columns += [c for c in t if c not in columns]
    out = {}
    for c in columns:
        parts = [t.get(c, [float("nan")] * len(next(iter(t.values()), []))) for t in tables]
        values = [v for part in parts for v in part]
        if any(isinstance(v, float) for v in values) and not any(isinstance(v, str) for v in values):
            values = [float(v) for v in values]
        out[c] = values
    return out


def _field(v) -> str:
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_table(path: str, columns: list, rows: list) -> None:
    """to_csv(index=False) of the rows (dicts) under `columns`: floats as
    their shortest round-trip repr, NaN as an empty field."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if columns:
            writer.writerow(columns)
        else:
            f.write("\n")
        writer.writerows([[_field(row[c]) for c in columns] for row in rows])


# --- histograms ---------------------------------------------------------------

def _dilated_region(shape_hw, target: np.ndarray, inverse: bool,
                    mask: np.ndarray | None) -> np.ndarray:
    """Boolean selector for the (inverse-)dilated vessel region
    (create_density_STD.py:212-311): the reference erodes the INVERTED
    target with a 3x3 kernel, keeping pixels where the eroded map is 0; the
    inverse battery keeps the FOV background instead."""
    t = target
    if t.shape != shape_hw:
        t = resize_nearest_cv2(t, shape_hw)
    inv_target = (255 - t).astype(np.uint8)
    dilated = erode3x3(inv_target)
    if inverse:
        m = mask
        if m is None:
            m = np.ones(shape_hw, np.uint8)
        elif m.shape != shape_hw:
            m = resize_nearest_cv2(m, shape_hw)
        return (m > 0) & (dilated > 0)
    return dilated == 0


def _histogram(data: np.ndarray, rnge):
    """ax.hist(data, bins="auto", range=rnge, density=True)'s counts and
    edges."""
    return np.histogram(data, bins="auto", range=rnge, density=True)


def _save_hist(data: np.ndarray, rnge, title: str, save_to: str):
    write_png(save_to, plot_bars(*_histogram(data, rnge)))


def dilated_hist(std_map: np.ndarray, target: np.ndarray, save_to: str, title: str,
                 rnge=(0, 0.5), inverse=False, mask: np.ndarray | None = None):
    """Single-image STD histogram over the (inverse-)dilated vessel region."""
    sel = _dilated_region(std_map.shape, target, inverse, mask)
    _save_hist(std_map[sel], rnge, title, save_to)


def hist_battery(models, std_data, mean_data, targets, masks, save_path) -> None:
    """The per-model aggregate histogram battery (create_density_STD.py:
    172-311): the FOV-masked CV histogram, the dilated-vessel STD/CV
    histograms and the inverse-dilated (FOV background) variants, each in a
    file of its own."""
    os.makedirs(save_path, exist_ok=True)
    for model in models:
        stds = std_data.get(model) or {}
        means = mean_data.get(model) or {}
        if not stds:
            continue

        cv_chunks = []
        for i, std in stds.items():
            if i not in means or not masks or i not in masks:
                continue
            cv = _cv_values(std, means[i], masks[i])
            cv_chunks.append(cv[~np.isnan(cv)])
        if cv_chunks:
            _save_hist(np.concatenate(cv_chunks), (0, 5), f"{model} DB CV",
                       join(save_path, f"CV_Histogram_{model}.png"))

        if not targets:
            continue
        for inverse, tag in ((False, "Dilated"), (True, "InvDilated")):
            std_chunks, cvn_chunks, cvd_chunks = [], [], []
            for i, std in stds.items():
                if i not in targets:
                    continue
                s2d = std[0, 0]
                sel = _dilated_region(s2d.shape, targets[i], inverse,
                                      masks.get(i) if masks else None)
                std_chunks.append(s2d[sel])
                if i in means:
                    cvn_chunks.append(s2d[sel])
                    cvd_chunks.append(means[i][0, 0][sel])
            if std_chunks:
                _save_hist(np.concatenate(std_chunks), (0, 0.5), f"{model} {tag} STD",
                           join(save_path, f"STD_{tag}_Histogram_{model}.png"))
            if cvd_chunks:
                num = np.concatenate(cvn_chunks)
                den = np.concatenate(cvd_chunks)
                # zero-mean guard (dilated_agg_cv_hist: both -> 1e-8)
                num = np.where(den == 0, 1e-8, num)
                den = np.where(den == 0, 1e-8, den)
                _save_hist(num / den, (0, 5), f"{model} {tag} CV",
                           join(save_path, f"CV_{tag}_Histogram_{model}.png"))


# --- the report ---------------------------------------------------------------

def load_matrix_tensors(results_root: str, models=MODELS) -> dict:
    """All models' mean/std tensors and metrics tables (the reference's
    data-loading block, create_density_STD.py:371-396). "metrics" is the
    concatenated table ({} when no model has one)."""
    out = {"mean_db": {}, "std_db": {}, "mean_rot": {}, "std_rot": {},
           "mean_db_dep": {}, "std_db_dep": {}}
    frames = []
    for model in models:
        path = join(results_root, model)
        for csv_path, name in ((join(path, "statistics", "val_images", "metrics.csv"), model),
                               (join(path, "dropblock_uncertainty", "statistics", "val_images",
                                     "metrics.csv"), f"{model}_DB")):
            if exists(csv_path):
                table = read_table(csv_path)
                table["name"] = [name] * len(next(iter(table.values()), []))
                frames.append(table)
        for kind, folder in (("db", join("dropblock_uncertainty", "tensors")),
                             ("rot", "rotation_uncertainty"),
                             # the dependent-variant run (create_density_DID's
                             # comparison set), saved beside the independent one
                             ("db_dep", join("dropblock_uncertainty_dep", "tensors"))):
            for stat in ("mean", "std"):
                out[f"{stat}_{kind}"][model] = extract_tensors(join(path, folder), f"{stat}.pt")
    out["metrics"] = concat_tables(frames) if frames else {}
    return out


def _read_val_pngs(aug_root, kind: str) -> dict:
    """{image id: uint8 (H, W)} of <aug_root>/val/<kind>, as PIL's
    convert("L") reads them."""
    folder = join(aug_root, "val", kind)
    if not exists(folder):
        return {}
    return {int(f.split("_")[0]): read_png(join(folder, f)) for f in os.listdir(folder)}


def create_density_report(results_root: str, save_path: str, aug_root: str | None = None,
                          models=MODELS, kinds=("std", "cv", "hist"), device=None) -> None:
    """The plot battery of the reference's density jobs (create_density.py:
    3-5) from a results tree: reads it, then render_density_report. The KDE
    runs on `device` (the card by default), resolved before anything is
    read."""
    device = resolve_device(device)
    data = load_matrix_tensors(results_root, models)
    masks = _read_val_pngs(aug_root, "masks") if aug_root else {}
    targets = _read_val_pngs(aug_root, "targets") if aug_root else {}
    render_density_report(data, masks, targets, save_path, models, kinds, device)


def render_density_report(data: dict, masks: dict, targets: dict, save_path: str,
                          models=MODELS, kinds=("std", "cv", "hist"), device=None) -> None:
    """Grouped STD KDEs for DB and ROT, per-model single densities and the
    magnitude tables ('std'), CV densities ('cv'), the histogram battery
    ('hist', with targets and masks), the dependent-vs-independent overlays
    ('did') and all_metrics.csv, from tensors in memory (load_matrix_tensors'
    dict)."""
    device = resolve_device(device)
    all_dir = join(save_path, "All_Models")
    single_dir = join(save_path, "Single_Models")
    os.makedirs(all_dir, exist_ok=True)
    os.makedirs(single_dir, exist_ok=True)

    if "std" in kinds:
        for group_name, group in GROUPS.items():
            std_density(group, data["std_db"], 0.01, (0, 0.5), 1000,
                        f"{group_name} DB STD", "STD", "Density", all_dir, device)
            std_density(group, data["std_rot"], 0.01, (0, 0.3), 1000,
                        f"{group_name} ROT STD", "STD", "Density", all_dir, device)
        for model in models:
            if data["std_db"].get(model):
                std_single_density(model, data["std_db"], 0.01, (0, 0.5), 250,
                                   f"{model} DB STD", "STD", "Density", single_dir, device)
            if data["std_rot"].get(model):
                std_single_density(model, data["std_rot"], 0.01, (0, 0.3), 250,
                                   f"{model} ROT STD", "STD", "Density", single_dir, device)
        for kind in ("db", "rot"):
            rows = calculate_magnitudes({m: d for m, d in data[f"std_{kind}"].items() if d})
            write_table(join(save_path, f"std_magnitudes_{kind}.csv"),
                        MAGNITUDE_COLUMNS if rows else [], rows)

    if "cv" in kinds:
        for group_name, group in GROUPS.items():
            cv_density(group, data["std_db"], data["mean_db"], masks, (0, 5), 1000,
                       f"{group_name} DB CV", all_dir, device)
            cv_density(group, data["std_rot"], data["mean_rot"], masks, (0, 5), 1000,
                       f"{group_name} ROT CV", all_dir, device)

    if "hist" in kinds:
        hist_battery(models, data["std_db"], data["mean_db"], targets, masks,
                     join(save_path, "Histograms"))

    if "did" in kinds:
        # dependent-vs-independent overlays (create_density_DID.py): for each
        # model with both dropblock runs, the two STD KDEs, in matplotlib's
        # default colour order
        for model in models:
            indep = data["std_db"].get(model, {})
            dep = data.get("std_db_dep", {}).get(model, {})
            if not indep or not dep:
                continue
            curves = []
            for d, style in ((indep, "-"), (dep, "--")):
                vals = np.concatenate([v.flatten() for v in d.values()])
                vals = vals[vals > 0.01]
                if vals.size < 2:
                    continue
                xs, dens = _kde_curve(vals, (0, 0.5), 1000, device)
                curves.append((xs, dens, style, TAB[_CYCLE[len(curves)]], 0.7))
            write_png(join(all_dir, f"{model}_DvUD_STD.png"), plot_curves(curves, (0, 0.5)))

    metrics = data.get("metrics") or {}
    if metrics:
        columns = list(metrics)
        n = len(metrics[columns[0]])
        write_table(join(save_path, "all_metrics.csv"), columns,
                    [{c: metrics[c][i] for c in columns} for i in range(n)])
