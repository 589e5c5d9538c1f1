"""General helpers (twin of unet_research_tpu/utils/general.py; reference
unet_code/utils/utils_general.py)."""

from __future__ import annotations

import os
import random
from os.path import exists

import numpy as np


def create_dir(path: str):
    """Create `path`, or `path0`..`path5` if taken; None when all exist
    (reference utils_general.py:15-30: the evaluation CLIs rely on this
    suffix retry not to clobber a rerun)."""
    d = path
    if not exists(d):
        os.makedirs(d)
        return d
    for i in range(6):
        d = path + str(i)
        if not exists(d):
            os.makedirs(d)
            return d
    print("Could not create directory.")
    return None


def to_u8(arr) -> np.ndarray:
    """float [0, 1] HWC/HW -> uint8 HW/HWC, as torchvision's ToPILImage
    quantises (utils_general.py:9-12): clip(round(a * 255), 0, 255), a
    trailing channel of 1 squeezed; uint8 input passes through."""
    a = np.asarray(arr)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    if a.dtype != np.uint8:
        a = np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)
    return a


def seed_everything(seed: int) -> None:
    """Seed python and numpy (PL seed_everything's host part). The port's
    engines and trainer take explicit torch generators."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PL_GLOBAL_SEED"] = str(seed)
