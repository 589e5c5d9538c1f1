"""Augmented-dataset generation (twin of unet_research_tpu/data/augment.py):
create_augmentations with batched on-device warps.

Reference pipeline (preprocessing/create_augmentations.py): seed 1234, DRIVE
train 20 images split 70/30 into 14 train / 6 val; train transform =
A.ToGray + A.Flip(p=.5) + A.Rotate(limit=180, p=.95, border_mode=REPLICATE),
36 augments per train image (504 files x3); val/test get ToGray only; output
tree {train,val}/{images,targets,masks} + test/{images,masks} with
{i}_image.png / {i}_target.png / {i}_mask.png naming (gen_givens,
utils_preprocessing.py:16-33) and 1-based zero-padded test ids (gen_tests,
utils_preprocessing.py:82-95).

Each source image's augments are one batched call on the device, as JAX
vmaps them (`_augment_batch`): the gray conversion, then one gather per
output kind in which member k samples the flip of the input its plan names
(the four flips of one image, not one copy per member) along the source
maps of its angle. The random plan (flip codes, angles, apply-gates) is
drawn host-side with the same numpy calls as JAX, so one seed gives one
plan in both packages, and one train/val split. Files are written with the
port's PNG writer (utils/png.py).
"""

from __future__ import annotations

import os
from os.path import exists, join

import numpy as np
import torch

from unet_research_tpu_torch.data.drive import load_drive
from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.ops.image import (flip_nhwc, resize_bilinear, rotate_cv2_like,
                                               to_gray_rgb)
from unet_research_tpu_torch.utils.general import seed_everything
from unet_research_tpu_torch.utils.png import write_png


def _augment_batch(im_rgb: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor, angles,
                   rot_on, flip_v, flip_h):
    """Produce len(angles) augments of one (im, gt, mask) triple, on the
    tensors' device.

    im_rgb: (H, W, 3) float 0..255; gt/mask: (H, W, 1) float 0..255;
    angles/rot_on/flip_v/flip_h: the (num,) plan (numpy or tensors). Gray
    image bilinear, target and mask nearest, replicate borders. Returns
    (num, H, W, 3), (num, H, W, 1), (num, H, W, 1) float32."""
    dev = im_rgb.device

    def plan(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)

    rot, fv, fh = (plan(a, torch.bool) for a in (rot_on, flip_v, flip_h))
    # a member that is not rotated takes angle 0, which samples each pixel
    # at its own centre: exactly the flipped input, as JAX's select gives
    angles = torch.where(rot, plan(angles, torch.float32), 0.0)
    source = 2 * fv.to(torch.int64) + fh.to(torch.int64)

    def flips(x):  # source 0: as is, 1: horizontal, 2: vertical, 3: both
        return torch.cat([x, flip_nhwc(x, 1), flip_nhwc(x, 0), flip_nhwc(x, -1)])

    gray = to_gray_rgb(im_rgb[None])  # ToGray applies to the image only
    return (rotate_cv2_like(flips(gray), angles, "bilinear", "replicate", source),
            rotate_cv2_like(flips(gt[None]), angles, "nearest", "replicate", source),
            rotate_cv2_like(flips(mask[None]), angles, "nearest", "replicate", source))


def _save_u8(arr, path: str, mode: str) -> None:
    """Round half to even (np.round), clip to 0..255 and write an RGB or an
    L PNG; a (H, W, 1) array written as L drops its channel."""
    a = np.clip(np.round(np.asarray(arr)), 0, 255).astype(np.uint8)
    if mode == "L" and a.ndim == 3:
        a = a[..., 0]
    write_png(path, a)


def _gen_subdir(path: str, include_targets: bool = True):
    im_path = join(path, "images")
    mask_path = join(path, "masks")
    os.makedirs(im_path)
    os.makedirs(mask_path)
    if include_targets:
        target_path = join(path, "targets")
        os.makedirs(target_path)
        return im_path, target_path, mask_path
    return im_path, mask_path


def _plan(rng: np.random.Generator, num: int, flip_p=0.5, rot_p=0.95, limit=180.0):
    """Random transform plan matching A.Flip(p)/A.Rotate(limit, p) draws:
    (angles float32, rot_on, flip_v, flip_h), each (num,) numpy."""
    flip_on = rng.random(num) < flip_p
    codes = rng.integers(-1, 2, num)  # cv2 flip code in {-1,0,1}
    flip_v = flip_on & ((codes == 0) | (codes == -1))
    flip_h = flip_on & ((codes == 1) | (codes == -1))
    rot_on = rng.random(num) < rot_p
    angles = rng.uniform(-limit, limit, num).astype(np.float32)
    return angles, rot_on, flip_v, flip_h


def _identity_plan(num: int):
    zero = np.zeros(num, np.float32)
    return zero, zero.astype(bool), zero.astype(bool), zero.astype(bool)


def _on_device(im, gt, mask, device):
    """A DRIVE item as float32 tensors on `device`: (H, W, 3), (H, W, 1), (H, W, 1)."""
    im = torch.as_tensor(np.asarray(im, np.float32)).to(device)
    gt, mask = (torch.as_tensor(np.asarray(a, np.float32)).to(device)[..., None]
                for a in (gt, mask))
    return im, gt, mask


def gen_givens(dest: str, num: int, items, seed: int, augment: bool, device=None) -> int:
    """Write `num` augments per (im, gt, mask) item to dest/{images,targets,
    masks} with running {i}_* names (utils_preprocessing.py:16-33), each
    item's augments as one batched call on `device` (the card unless the
    CPU is asked for)."""
    device = resolve_device(device)
    seed_everything(seed)
    rng = np.random.default_rng(seed)
    im_path, target_path, mask_path = _gen_subdir(dest, include_targets=True)
    num_added = 0
    for im, gt, mask in items:
        plans = _plan(rng, num) if augment else _identity_plan(num)
        out = _augment_batch(*_on_device(im, gt, mask, device), *plans)
        ims, gts, masks = (t.cpu().numpy() for t in out)
        for i in range(num):
            _save_u8(gts[i], join(target_path, f"{num_added}_target.png"), "L")
            _save_u8(ims[i], join(im_path, f"{num_added}_image.png"), "RGB")
            _save_u8(masks[i], join(mask_path, f"{num_added}_mask.png"), "L")
            num_added += 1
    return num_added


def gen_givens_resized(dest: str, sizes: list[int], num: list[int], items, seed: int,
                       resize_up: bool, augment: bool = True, device=None) -> int:
    """Resized-dataset writer (reference utils_preprocessing.py:36-79,
    unused by the checked-in CLI but part of the preprocessing surface):
    builds a shuffled per-output size plan from (sizes, num) pairs, cycles
    the items until the plan is exhausted, and writes each transformed
    triple either at size s x s (resize_up=False) or degraded down-then-up
    at the original size (resize_up=True). Size -1 keeps the original."""
    if len(sizes) != len(num):
        raise ValueError(f"{len(sizes)} sizes but {len(num)} counts")
    device = resolve_device(device)
    plan = np.repeat(np.asarray(sizes), np.asarray(num))
    rng_plan = np.random.default_rng(seed)
    rng_plan.shuffle(plan)
    total = int(plan.size)

    seed_everything(seed)
    rng = np.random.default_rng(seed)
    im_path, target_path, mask_path = _gen_subdir(dest, include_targets=True)

    num_added = 0
    while num_added < total:
        for im, gt, mask in items:
            if num_added >= total:
                break
            plans = _plan(rng, 1) if augment else _identity_plan(1)
            triple = [t[0] for t in _augment_batch(*_on_device(im, gt, mask, device), *plans)]
            s = int(plan[num_added])
            if s != -1:
                orig_hw = (triple[0].shape[0], triple[0].shape[1])
                down = [resize_bilinear(t, (s, s)) for t in triple]
                triple = [resize_bilinear(t, orig_hw) for t in down] if resize_up else down
            ims0, gts0, masks0 = (t.cpu().numpy() for t in triple)
            _save_u8(gts0, join(target_path, f"{num_added}_target.png"), "L")
            _save_u8(ims0, join(im_path, f"{num_added}_image.png"), "RGB")
            _save_u8(masks0, join(mask_path, f"{num_added}_mask.png"), "L")
            num_added += 1
    return num_added


def gen_tests(dest: str, items, device=None) -> int:
    """ToGray-only test copies, 1-based zero-padded names
    (utils_preprocessing.py:82-95)."""
    device = resolve_device(device)
    im_path, mask_path = _gen_subdir(dest, include_targets=False)
    count = 1
    for im, _, mask in items:
        gray = to_gray_rgb(torch.as_tensor(np.asarray(im, np.float32)).to(device)[None])
        _save_u8(gray[0].cpu().numpy(), join(im_path, f"{str(count).zfill(2)}_image.png"), "RGB")
        _save_u8(mask, join(mask_path, f"{str(count).zfill(2)}_mask.png"), "L")
        count += 1
    return count - 1


def create_augmentations(drive_root: str, dest: str = "augmented_data", seed: int = 1234,
                         num_train: int = 36, training_pct: float = 0.7, device=None) -> str:
    """Full dataset generation (create_augmentations.py __main__) on
    `device`, the card unless the CPU is asked for; without a card it
    raises before it reads or writes anything."""
    device = resolve_device(device)
    seed_everything(seed)
    given = load_drive(drive_root, "training")
    test = load_drive(drive_root, "test")

    training_len = int(len(given) * training_pct)
    perm = np.random.permutation(len(given))  # torch random_split equivalent
    train_idx, val_idx = perm[:training_len], perm[training_len:]

    out = dest
    if exists(out):
        for i in range(1, 5):
            out = dest + str(i)
            if not exists(out):
                break
        else:
            raise FileExistsError("Could not create destination directory.")
    os.makedirs(out)

    train_dest = join(out, "train")
    val_dest = join(out, "val")
    test_dest = join(out, "test")
    for p in (train_dest, val_dest, test_dest):
        os.makedirs(p)

    train_items = [given[i] for i in train_idx]
    val_items = [given[i] for i in val_idx]
    test_items = [test[i] for i in range(len(test))]

    gen_givens(train_dest, num_train, train_items, seed, augment=True, device=device)
    gen_givens(val_dest, 1, val_items, seed, augment=False, device=device)
    gen_tests(test_dest, test_items, device=device)
    return out
