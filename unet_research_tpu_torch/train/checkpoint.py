"""Checkpointing with the reference's naming and best-only retention (twin
of unet_research_tpu/train/checkpoint.py).

The reference keeps exactly one checkpoint, the best by val_loss_epoch,
named "model-{epoch:02d}-{val_loss:.2f}", which PL renders as
"model-epoch=XX-val_loss=Y.YY.ckpt" (base_model_tests/training.py:204-210);
the evaluation scripts pick up the first entry of model_info/
(testing_script.py:11).

Format: `torch.save({"state_dict", "meta", "optimizer"})`, the reference PL
.ckpt layout, so `utils/convert.py::load_reference_checkpoint` reads the
weights of a file written here. The JAX package writes flax msgpack files
instead: `utils/convert.py::load_model_checkpoint` reads their weights (not
their optimizer state).
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional

import torch


def save_checkpoint(path: str, state_dict: dict, meta: Optional[dict] = None,
                    optimizer: Optional[dict] = None) -> str:
    """Write the model state_dict (on the CPU), JSON-able meta and an
    optional optimizer state_dict to `path`, atomically."""
    payload = {"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
               "meta": dict(meta or {})}
    if optimizer is not None:
        payload["optimizer"] = optimizer
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str):
    """(state_dict, meta, optimizer state_dict or None) of a file written by
    save_checkpoint, on the CPU."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["state_dict"], payload.get("meta", {}), payload.get("optimizer")


class BestCheckpointKeeper:
    """save_top_k=1 ModelCheckpoint on a min-monitored metric
    (training.py:204-210): keeps only the best epoch's file, named
    model-epoch=XX-val_loss=Y.YY.ckpt in `dirpath`."""

    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.best_metric = float("inf")
        self.best_path: Optional[str] = None

    def update(self, epoch: int, val_loss: float, state_dict: dict,
               meta: Optional[dict] = None, optimizer: Optional[dict] = None) -> Optional[str]:
        """Save if this epoch improves the monitor; returns the new path or None."""
        if val_loss >= self.best_metric:
            return None
        name = f"model-epoch={epoch:02d}-val_loss={val_loss:.2f}.ckpt"
        path = join(self.dirpath, name)
        full_meta = {"epoch": epoch, "val_loss": float(val_loss)}
        full_meta.update(meta or {})
        save_checkpoint(path, state_dict, full_meta, optimizer=optimizer)
        if self.best_path and self.best_path != path and os.path.exists(self.best_path):
            os.remove(self.best_path)
        self.best_metric = float(val_loss)
        self.best_path = path
        return path


def find_checkpoint(model_info_dir: str) -> str:
    """First entry of a model_info/ dir, as the reference's testing scripts
    locate the best checkpoint (testing_script.py:11)."""
    entries = sorted(os.listdir(model_info_dir))
    if not entries:
        raise FileNotFoundError(f"no checkpoint in {model_info_dir}")
    return join(model_info_dir, entries[0])
