"""The reference's resize around the forward under the MF 'uni' policy
(multi-fidelity/MF-training-UNI.py:49-86) and the first SGD steps of a fit
under a size plan, on reference/unet.py. Nothing here imports the program
under test.

A step at size s != -1 square-pads image, target and mask (the reference's
asymmetric split, utils/utils_general.py:32-43: the height's odd pixel to
the bottom, the width's to the left), resizes the image and the target to s
x s, runs the forward, resizes the segmentation and the target back up and
takes the masked BCE against the square-padded mask, which is never resized
(the UNI quirk); at s = -1 the forward runs on the square-padded frame. The
resize is torchvision's tensor bilinear: F.interpolate, align_corners
False, no antialias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import tasks, unet


def square_pad(img: torch.Tensor) -> torch.Tensor:
    """NHWC zero-padded to a max(H, W) square."""
    h, w = img.shape[1], img.shape[2]
    size = max(h, w)
    top = (size - h) // 2
    right = (size - w) // 2
    return F.pad(img, (0, 0, size - w - right, right, top, size - h - top))


def resize(img: torch.Tensor, size: tuple) -> torch.Tensor:
    """NHWC bilinear resize to size = (H, W)."""
    out = F.interpolate(img.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def uni_io(params, cfg, im, gt, mask, size: int, drop, quant: bool) -> tuple:
    """(segmentation, target, mask) of one batch at plan entry `size`."""
    im, gt, mask = square_pad(im), square_pad(gt), square_pad(mask)
    full = (im.shape[1], im.shape[2])
    if size != -1:
        im, gt = resize(im, (size, size)), resize(gt, (size, size))
    seg = unet.forward(params, im, cfg, drop, quant)
    if size != -1:
        seg, gt = resize(seg, full), resize(gt, full)
    return seg, gt, mask


@tasks.plain_float32()
def train_steps(params0: dict, cfg: dict, batches: list, sizes: list, keys: list,
                drop_probs: list, lr: float, momentum: float, block: int,
                quant: bool = False) -> dict:
    """tasks.train_steps at batch 1 with step k at plan entry sizes[k]
    (uni_io): per-step losses, the first step's gradient per leaf and the
    parameters after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    bufs = {k: torch.zeros_like(v) for k, v in params0.items()}
    losses, first = [], None
    for (im, gt, mask), size, step_keys, p in zip(batches, sizes, keys, drop_probs):
        drop = unet.Drop(step_keys, p, block)
        seg, gt2, mask2 = uni_io(params, cfg, im, gt, mask, size, drop, quant)
        loss = tasks.bce_terms(seg, gt2, mask2) / float((mask2 != 0).sum())
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, v in params.items():
                bufs[k].mul_(momentum).add_(v.grad)
                v.sub_(lr * bufs[k])
                v.grad = None
        if first is None:
            first = {k: b.clone() for k, b in bufs.items()}
    return {"losses": losses, "grads": first,
            "params": {k: v.detach() for k, v in params.items()}}
