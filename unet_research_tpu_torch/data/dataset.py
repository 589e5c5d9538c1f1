"""A split held in host memory (twin of the ArrayDataset of
unet_research_tpu/data/dataset.py).

The reference's UnetDataset (unet_code/utils/utils_dataset.py:8-78) pairs
image/target/mask files by sorted index and normalises with ToTensor. Here
the split is one uint8 NHWC array per kind, read once from its PNG files
(`load_split`, through utils/png.py: PIL is not needed) and normalised to
float32/255 when a batch is taken. The raw DRIVE tree is read by
data/drive.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from os.path import join

import numpy as np

from unet_research_tpu_torch.utils.png import read_png


def _load_dir(root: str) -> np.ndarray:
    """Every image in `root`, in sorted order, as 8-bit gray: a uint8
    (N, H, W, 1) stack."""
    return np.stack([read_png(join(root, name)) for name in sorted(os.listdir(root))])[..., None]


@dataclass
class ArrayDataset:
    """images/targets/masks: (N, H, W, 1) uint8; targets all 0 and masks
    all 255 where the split has none (utils_dataset.py:58-71)."""

    images: np.ndarray
    targets: np.ndarray
    masks: np.ndarray

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx):
        return (
            self.images[idx].astype(np.float32) / 255.0,
            self.targets[idx].astype(np.float32) / 255.0,
            self.masks[idx].astype(np.float32) / 255.0,
        )

    def as_float(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The whole split as float32 / 255 (image, target, mask) arrays."""
        return self[:]

    def subset(self, n: int) -> "ArrayDataset":
        """Sequential truncation (the RED policy's torch Subset(range(n)),
        reference base_model_tests/training-RED.py:163-167)."""
        return ArrayDataset(self.images[:n], self.targets[:n], self.masks[:n])


def load_split(split_root: str, with_targets: bool = True) -> ArrayDataset:
    """One split directory with images/, targets/ and masks/ (the layout the
    augmentation generator writes, utils_preprocessing.py:98-108). Without
    targets/ (or with_targets=False) the targets are all 0; without masks/
    the masks are all 255."""
    images = _load_dir(join(split_root, "images"))
    tdir, mdir = join(split_root, "targets"), join(split_root, "masks")
    if with_targets and os.path.isdir(tdir):
        targets = _load_dir(tdir)
    else:
        targets = np.zeros_like(images)
    masks = _load_dir(mdir) if os.path.isdir(mdir) else np.full_like(images, 255)
    return ArrayDataset(images, targets, masks)
