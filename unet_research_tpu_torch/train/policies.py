"""Resize-policy registry: the reference's 8 forked training scripts as data
(twin of unet_research_tpu/train/policies.py).

The reference implements its multi-fidelity matrix as eight near-identical
CLI forks that differ only in how (image, gt, mask) are resized around the
forward pass. Here each variant is one policy consumed by one trainer:

- 'none'    base_model_tests/training.py: native resolution.
- 'red'     training-RED.py: the same, train set sequentially truncated by
            train_ratio (ArrayDataset.subset).
- 'uni'     MF-training-UNI.py:49-86: per-image size plan (1/3 each of
            {orig, 256, 128}); square-pad, downsize image+gt, forward,
            upsize seg+gt, loss at full size against the UNRESIZED mask
            (the reference's UNI quirk).
- 'rat'     MF-training-RAT.py: 1:2:4 plan of {orig, 256, 128}; the mask IS
            resized down and back up with seg/gt.
- 'rsz-rat' MF-training-RSZ-RAT.py:64-69: RAT plan, but image/gt/mask are
            degraded (down THEN back up) before the model, so training always
            runs at full resolution with lost information.
- 'lft'     LF-training-LFT.py:38-50: train/val/predict all square-padded
            and resized to train_size^2.
- 'hft'     LF-training-HFT.py:45-53: train/val forward at train_size^2 and
            the segmentation resized back up for a full-res loss; predict
            runs at native resolution.
- 'lft-up'  LF-training-LFT-UP.py:43-52: image/gt/mask degraded down->up
            before the model at full resolution; predict downsizes to
            train_size like LFT.

`size` is the per-batch entry of an MF size plan: -1 (native) or a side.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from unet_research_tpu_torch.ops.image import resize_bilinear, square_pad

ForwardFn = Callable[..., object]  # forward(im) -> seg


@dataclasses.dataclass(frozen=True)
class ResizePolicy:
    """One training-resize policy; `size` is the only per-batch variation."""

    kind: str  # none|red|uni|rat|rsz-rat|lft|hft|lft-up
    train_size: int = -1  # LF policies' -new_size
    uses_size_plan: bool = False

    def train_io(self, forward: ForwardFn, im, gt, mask, size: int = -1):
        """Returns (seg, gt, mask) ready for the masked-rescaled BCE."""
        k = self.kind
        if k in ("none", "red"):
            return forward(im), gt, mask

        if k in ("uni", "rat"):
            im, gt, mask = square_pad(im), square_pad(gt), square_pad(mask)
            full = (im.shape[-3], im.shape[-2])
            if size != -1:
                im = resize_bilinear(im, (size, size))
                gt = resize_bilinear(gt, (size, size))
                if k == "rat":
                    mask = resize_bilinear(mask, (size, size))
            seg = forward(im)
            if size != -1:
                seg = resize_bilinear(seg, full)
                gt = resize_bilinear(gt, full)
                if k == "rat":
                    mask = resize_bilinear(mask, full)
            return seg, gt, mask

        if k == "rsz-rat":
            im, gt, mask = square_pad(im), square_pad(gt), square_pad(mask)
            full = (im.shape[-3], im.shape[-2])
            if size != -1:
                im = resize_bilinear(resize_bilinear(im, (size, size)), full)
                gt = resize_bilinear(resize_bilinear(gt, (size, size)), full)
                mask = resize_bilinear(resize_bilinear(mask, (size, size)), full)
            return forward(im), gt, mask

        t = (self.train_size, self.train_size)
        if k == "lft":
            im, gt, mask = square_pad(im), square_pad(gt), square_pad(mask)
            return (forward(resize_bilinear(im, t)), resize_bilinear(gt, t),
                    resize_bilinear(mask, t))

        if k == "hft":
            im, gt, mask = square_pad(im), square_pad(gt), square_pad(mask)
            full = (im.shape[-3], im.shape[-2])
            seg = forward(resize_bilinear(im, t))
            return resize_bilinear(seg, full), gt, mask

        if k == "lft-up":
            im, gt, mask = square_pad(im), square_pad(gt), square_pad(mask)
            full = (im.shape[-3], im.shape[-2])
            im = resize_bilinear(resize_bilinear(im, t), full)
            gt = resize_bilinear(resize_bilinear(gt, t), full)
            mask = resize_bilinear(resize_bilinear(mask, t), full)
            return forward(im), gt, mask

        raise ValueError(f"unknown policy {k}")

    def val_io(self, forward: ForwardFn, im, gt, mask):
        """LF validation mirrors the train step; MF keeps native resolution."""
        if self.kind in ("lft", "hft", "lft-up"):
            return self.train_io(forward, im, gt, mask)
        return forward(im), gt, mask

    def predict_io(self, forward: ForwardFn, im, gt, mask):
        """(masked seg, im, gt, mask) as the reference predict_steps return
        them (utils_training.py:72-78; LF overrides)."""
        if self.kind in ("lft", "lft-up"):
            t = (self.train_size, self.train_size)
            im, gt, mask = square_pad(im), square_pad(gt), square_pad(mask)
            im, gt, mask = (resize_bilinear(im, t), resize_bilinear(gt, t),
                            resize_bilinear(mask, t))
        seg = forward(im)
        return seg * mask, im, gt, mask


POLICIES = {
    "none": ResizePolicy("none"),
    "red": ResizePolicy("red"),
    "uni": ResizePolicy("uni", uses_size_plan=True),
    "rat": ResizePolicy("rat", uses_size_plan=True),
    "rsz-rat": ResizePolicy("rsz-rat", uses_size_plan=True),
}


def lf_policy(kind: str, train_size: int) -> ResizePolicy:
    if kind not in ("lft", "hft", "lft-up"):
        raise ValueError(f"not a low-fidelity policy: {kind}")
    return ResizePolicy(kind, train_size=train_size)


def make_size_plan(kind: str, len_orig: int, num_augmentations: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-batch size plan for the MF policies, drawn as the JAX package
    draws it (same numpy calls, so one seed gives one plan in both).

    'uni': ceil(len/3) each of 128 and 256, rest original
    (MF-training-UNI.py:32-44). 'rat'/'rsz-rat': x=len/7, 4x of 128, 2x of
    256, rest original (MF-training-RAT.py:33-36). Shuffled per original
    image, then each entry repeated num_augmentations times, which is why
    the MF train loader runs unshuffled (batch_idx indexes this plan)."""
    if kind == "uni":
        num_128 = math.ceil(len_orig / 3)
        num_256 = math.ceil(len_orig / 3)
    elif kind in ("rat", "rsz-rat"):
        x = len_orig / 7
        num_128 = math.ceil(4 * x)
        num_256 = math.ceil(2 * x)
    else:
        raise ValueError(f"no size plan for policy {kind}")
    num_orig = len_orig - num_128 - num_256
    sizes = np.array([-1] * num_orig + [256] * num_256 + [128] * num_128)
    if rng is None:
        rng = np.random.default_rng()
    rng.shuffle(sizes)
    return np.repeat(sizes, num_augmentations)
