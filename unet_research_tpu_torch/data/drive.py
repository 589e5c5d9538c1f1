"""Raw DRIVE dataset reader, the ImLoader equivalent (twin of
unet_research_tpu/data/drive.py).

Reads the original DRIVE tree (reference layout
Unet_research/datasets/{training,test}): training/{images .tif, 1st_manual
.gif, mask .gif}, test/{images, mask}. Images load as RGB, targets and
masks as L, as unet_code/utils/utils_imloader.py:35-53 loads them, through
the port's own TIFF and GIF readers (utils/tiff.py, utils/gif.py), which
give what PIL's `convert` gives. A file that is neither TIFF nor GIF raises
ValueError naming it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from os.path import isdir, join

import numpy as np

from unet_research_tpu_torch.utils.gif import read_gif
from unet_research_tpu_torch.utils.tiff import read_tiff


def _listdir_sorted(root: str) -> list[str]:
    return sorted(os.listdir(root))


@dataclass
class DriveImages:
    """One DRIVE split in host memory: images uint8 (N, H, W, 3) RGB,
    targets/masks uint8 (N, H, W) or None."""

    images: np.ndarray
    targets: np.ndarray | None
    masks: np.ndarray | None

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx):
        return (
            self.images[idx],
            None if self.targets is None else self.targets[idx],
            None if self.masks is None else self.masks[idx],
        )


def read_image(path: str, mode: str) -> np.ndarray:
    """A TIFF or GIF file (by its first bytes) as PIL's `convert(mode)`
    gives it."""
    with open(path, "rb") as f:
        head = f.read(6)
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return read_tiff(path, mode)
    if head in (b"GIF87a", b"GIF89a"):
        return read_gif(path, mode)
    raise ValueError(f"{path}: neither a TIFF nor a GIF file")


def _load(root: str, mode: str) -> np.ndarray:
    return np.stack([read_image(join(root, name), mode) for name in _listdir_sorted(root)])


def load_drive(dataset_root: str, split: str) -> DriveImages:
    """Load 'training' or 'test' from a DRIVE-layout root."""
    root = join(dataset_root, split)
    images = _load(join(root, "images"), "RGB")
    targets = None
    tdir = join(root, "1st_manual")
    if isdir(tdir):
        targets = _load(tdir, "L")
    masks = None
    mdir = join(root, "mask")
    if isdir(mdir):
        masks = _load(mdir, "L")
    return DriveImages(images, targets, masks)
