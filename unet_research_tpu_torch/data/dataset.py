"""A split held in host memory (twin of the ArrayDataset of
unet_research_tpu/data/dataset.py).

The reference's UnetDataset (unet_code/utils/utils_dataset.py:8-78) pairs
image/target/mask files by sorted index and normalises with ToTensor. Here
the split is one uint8 NHWC array per kind, normalised to float32/255 when a
batch is taken. Reading a split from disk (`load_split`, the DRIVE reader)
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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

    def subset(self, n: int) -> "ArrayDataset":
        """Sequential truncation (the RED policy's torch Subset(range(n)),
        reference base_model_tests/training-RED.py:163-167)."""
        return ArrayDataset(self.images[:n], self.targets[:n], self.masks[:n])
