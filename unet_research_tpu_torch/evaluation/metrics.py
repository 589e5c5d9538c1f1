"""Evaluation metrics and the final_test_metrics harness (twin of
unet_research_tpu/evaluation/metrics.py; reference
unet_code/utils/utils_metrics.py), on numpy, without sklearn or pandas
(the card has no sklearn; the port depends on numpy, torch and the
standard library only).

final_test_metrics writes the output tree the density scripts read
(create_density_STD.py:384-396):

    save_path/
      losses/{train_losses.txt, validation_losses.txt, loss_profile.png}
      test_images/{segmentations/{id}.png, examples/test_example_{id}.png}
      val_images/{examples/val_image_{id}/..., tensors/image_{id-1}/
                  segmentation.pt, metrics.csv}

`metrics.csv` is byte-equal to the JAX package's pandas `to_csv`; the loss
files hold the full per-epoch history, as in the JAX package.
"""

from __future__ import annotations

import csv
import math
import os
import warnings
from os.path import join
from typing import Optional

import numpy as np

from unet_research_tpu_torch.evaluation import artifacts

COLUMNS = ("Validation_Image", "F1_Vessel", "AUROC_Vessel", "Accuracy_Vessel")


def _fov(seg, gt, mask):
    """(y_true, y_score) over the field of view: the mask and gt truncated
    to integers (torch .long() in the reference), nonzero mask selected."""
    sel = np.asarray(mask).astype(np.int64) != 0
    return np.asarray(gt).astype(np.int64)[sel], np.asarray(seg)[sel]


def _auroc(pos: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve of scores `score` for the positives `pos`,
    as sklearn's roc_curve + auc compute it: cumulative true and false
    positives at each distinct score (descending), collinear points
    dropped, rates as fractions of the last point, trapezoids summed. It
    equals the Mann-Whitney statistic with average ranks for ties."""
    order = np.argsort(score, kind="stable")[::-1]
    ranked = score[order]
    idx = np.r_[np.flatnonzero(np.diff(ranked)), ranked.size - 1]
    tps = np.cumsum(pos[order].astype(np.float64))[idx]
    fps = 1 + idx.astype(np.float64) - tps
    if fps.size > 2:
        corner = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[corner], tps[corner]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())


def get_accuracy_metrics(seg: np.ndarray, gt: np.ndarray, mask: np.ndarray):
    """(f1_vessel, auroc, accuracy) over FOV pixels, as sklearn's f1_score,
    roc_auc_score and accuracy_score give them (reference
    utils_metrics.py:157-173). F1 and accuracy take the segmentation
    rounded half to even, AUROC the raw scores.

    F1 of class 1 is 2tp / (2tp + fp + fn), 0.0 when that is 0/0. AUROC is
    the trapezoid area under the ROC curve with sklearn's thresholds and
    operation order (`_auroc`), so that metrics.csv is byte-equal; when the
    FOV holds one class it is NaN, with a warning, as sklearn >= 1.6 gives
    it (older sklearn raised)."""
    y_true, y_score = _fov(seg, gt, mask)
    if y_true.size and (y_true.min() < 0 or y_true.max() > 1):
        raise ValueError("the ground truth must hold the classes 0 and 1 only")
    y_pred = np.round(y_score)
    pos, pred = y_true == 1, y_pred == 1
    tp = int(np.count_nonzero(pos & pred))
    denom = 2 * tp + int(np.count_nonzero(pred & ~pos)) + int(np.count_nonzero(pos & ~pred))
    f1 = 2.0 * tp / denom if denom else 0.0
    n_pos = int(np.count_nonzero(pos))
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        warnings.warn("Only one class is present in y_true. ROC AUC score is not "
                      "defined in that case.", UserWarning, stacklevel=2)
        auroc = float("nan")
    else:
        auroc = _auroc(pos, y_score)
    accuracy = float(np.mean(y_true == y_pred))
    return f1, auroc, accuracy


def dice_score(seg: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    """Dice of the thresholded segmentation inside the FOV (equals F1 of the
    vessel class)."""
    true, score = _fov(seg, gt, mask)
    pred = np.round(score)
    inter = float((pred * true).sum())
    denom = float(pred.sum() + true.sum())
    return 2.0 * inter / denom if denom else 1.0


def output_files(num_val: int, num_test: int, disable_test: bool = False) -> list:
    """The files final_test_metrics writes under save_path, as sorted
    relative paths (image ids are 1-based, tensor folders 0-based)."""
    files = ["losses/train_losses.txt", "losses/validation_losses.txt",
             "losses/loss_profile.png", "val_images/metrics.csv"]
    if not disable_test:
        for i in range(1, num_test + 1):
            files += [f"test_images/segmentations/{i}.png",
                      f"test_images/examples/test_example_{i}.png"]
    for i in range(1, num_val + 1):
        folder = f"val_images/examples/val_image_{i}"
        files += [f"{folder}/val_example_{i}.png", f"{folder}/contour_map.png",
                  f"{folder}/overlap_map.png", f"val_images/tensors/image_{i - 1}/segmentation.pt"]
    return sorted(files)


def final_test_metrics(predict, val_ds, test_ds, save_path: str,
                       history: Optional[dict] = None, disable_test: bool = False) -> dict:
    """The reference's post-training harness (utils_metrics.py:16-150).

    `predict(ds)` yields (idx, seg, im, gt, mask), numpy NHWC batches of
    one (Trainer.predict, or an uncertainty engine's mean). Returns the
    metrics as a dict of columns, the table also written to
    val_images/metrics.csv."""
    loss_folder = join(save_path, "losses")
    test_folder = join(save_path, "test_images")
    val_folder = join(save_path, "val_images")
    for d in (loss_folder, test_folder, val_folder):
        os.makedirs(d, exist_ok=True)

    history = history or {}
    train_losses = history.get("train_loss_epoch", [])
    val_losses = history.get("val_loss_epoch", [])
    artifacts.save_losses_as_text(train_losses, val_losses, loss_folder)
    artifacts.save_loss_profile(train_losses, val_losses, loss_folder)
    print("Saved Losses")

    if not disable_test:
        test_segs = join(test_folder, "segmentations")
        test_examples = join(test_folder, "examples")
        os.makedirs(test_segs, exist_ok=True)
        os.makedirs(test_examples, exist_ok=True)
        for im_id, seg, im, _, _ in predict(test_ds):
            im_id += 1
            artifacts.save_test_example(im[0], seg[0], im_id, test_examples)
            artifacts.save_segmentation(seg[0], im_id, test_segs)
        print("Saved Test Data")

    val_examples = join(val_folder, "examples")
    val_tensors = join(val_folder, "tensors")
    os.makedirs(val_examples, exist_ok=True)
    os.makedirs(val_tensors, exist_ok=True)

    scores = {name: [] for name in COLUMNS}
    for im_id, seg, im, gt, mask in predict(val_ds):
        seg0, im0, gt0, mask0 = seg[0], im[0], gt[0], mask[0]
        im_id += 1
        im_folder = join(val_examples, f"val_image_{im_id}")
        os.makedirs(im_folder, exist_ok=True)
        tensor_folder = join(val_tensors, f"image_{im_id - 1}")
        os.makedirs(tensor_folder, exist_ok=True)

        artifacts.save_val_example(im0, seg0, gt0, im_id, im_folder)
        artifacts.save_contour_map(seg0, gt0, im_folder)
        artifacts.save_overlap_map(seg0, gt0, im_folder)
        artifacts.save_tensor(seg0, join(tensor_folder, "segmentation.pt"))

        for name, value in zip(COLUMNS, (int(im_id), *get_accuracy_metrics(seg0, gt0, mask0))):
            scores[name].append(value)
    print("Saved Val Data")

    # Python ints and floats, whose str is what pandas' to_csv writes, and
    # NaN as pandas' empty na_rep
    with open(join(val_folder, "metrics.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        writer.writerows([["" if isinstance(v, float) and math.isnan(v) else v for v in row]
                          for row in zip(*scores.values())])
    print("Saved All Metrics")
    return scores
