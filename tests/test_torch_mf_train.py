"""-mode train of the port's multi-fidelity training CLIs
(cli/mf_training.py for uni, rat and rsz-rat, cli/lf_training.py for lft,
hft and lft-up) against the JAX CLIs' output trees, on the tree and tiny
model of tests/test_torch_mf_cli.py (-device cpu, float32, 1 epoch).

Tolerance: the same tree of files as the JAX CLI (the val_loss in the
checkpoint's name aside: the two packages initialise differently), a
finite metrics.csv, and a checkpoint that loads strictly into the model."""

import os
import re
from os.path import join

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from unet_research_tpu.cli import lf_training as jax_lf
from unet_research_tpu.cli import mf_training as jax_mf
from unet_research_tpu_torch.cli import lf_training, mf_training
from unet_research_tpu_torch.models.unet import UNet, canonical_config
from unet_research_tpu_torch.train.checkpoint import find_checkpoint
from unet_research_tpu_torch.utils.convert import load_model_checkpoint

SMALL = ["-filters", "4", "-model_depth", "2", "-group_norm_groups", "2",
         "--auto_lr_find", "False"]
CPU = ["-device", "cpu"]
TINY = dict(filters=4, model_depth=2, group_norm_groups=2)
# (cli name, policy, the CLI's own flags)
POLICIES = [("mf", p, ["-orig_train_size", "3", "-num_augmentations", "2"])
            for p in ("uni", "rat", "rsz-rat")] + [
            ("lf", p, ["-new_size", "16"]) for p in ("lft", "hft", "lft-up")]
MAINS = {"mf": (jax_mf.main, mf_training.main), "lf": (jax_lf.main, lf_training.main)}


@pytest.fixture(scope="module")
def aug_data(tmp_path_factory):
    """The augmented-layout tree of tests/test_torch_cli.py (train 6)."""
    root = tmp_path_factory.mktemp("aug")
    rng = np.random.default_rng(0)
    for split, n, with_targets in [("train", 6, True), ("val", 2, True), ("test", 2, False)]:
        d = root / split
        (d / "images").mkdir(parents=True)
        (d / "masks").mkdir()
        if with_targets:
            (d / "targets").mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (32, 32)).astype(np.uint8)).save(
                d / "images" / f"{i}_image.png")
            Image.fromarray(np.full((32, 32), 255, np.uint8)).save(d / "masks" / f"{i}_mask.png")
            if with_targets:
                Image.fromarray(((rng.random((32, 32)) > 0.5) * 255).astype(np.uint8)).save(
                    d / "targets" / f"{i}_target.png")
    return str(root)


def _tree(root):
    """Every directory (with a trailing /) and file under root, the
    checkpoint's val_loss field blanked."""
    out = set()
    for base, dirs, files in os.walk(root):
        rel = os.path.relpath(base, root)
        out |= {os.path.normpath(join(rel, n)) + "/" for n in dirs}
        out |= {re.sub(r"val_loss=[0-9.]+", "val_loss=*", os.path.normpath(join(rel, n)))
                for n in files}
    return out


@pytest.fixture(scope="module")
def jax_trained(aug_data, tmp_path_factory):
    """One -mode train run of each JAX CLI (rat and lft: one JAX run per CLI
    keeps the file's time down; every policy writes the same tree)."""
    root = tmp_path_factory.mktemp("jax_train")
    base = ["-mode", "train", "-data_path", aug_data, "-num_epochs", "1", "-seed", "7"] + SMALL
    return {"mf": jax_mf.main(base + ["-policy", "rat", "-save_path", str(root / "mf")]
                              + POLICIES[1][2]),
            "lf": jax_lf.main(base + ["-policy", "lft", "-save_path", str(root / "lf")]
                              + POLICIES[3][2])}


@pytest.mark.parametrize("cli,policy,flags", POLICIES, ids=[p for _, p, _ in POLICIES])
def test_training_mode_tree_matches_jax(aug_data, jax_trained, tmp_path, cli, policy, flags):
    argv = (["-mode", "train", "-policy", policy, "-data_path", aug_data, "-num_epochs", "1",
             "-seed", "7", "-save_path", str(tmp_path / "port")] + flags + SMALL + CPU)
    out = MAINS[cli][1](argv)
    assert _tree(out) == _tree(jax_trained[cli])
    df = pd.read_csv(join(out, "statistics", "val_images", "metrics.csv"))
    assert len(df) == 2 and np.isfinite(df.to_numpy()).all()
    sd, meta = load_model_checkpoint(find_checkpoint(join(out, "model_info")),
                                     canonical_config(**TINY))
    assert meta["epoch"] == 0
    UNet(canonical_config(**TINY), device="cpu").load_state_dict(sd)
