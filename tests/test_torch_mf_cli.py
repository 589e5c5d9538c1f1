"""The port's multi-fidelity CLIs (cli/mf_training.py, cli/lf_training.py,
cli/base_model_mf.py) and utils/convert.py::main against the JAX package:
one JAX checkpoint of a tiny model (-filters 4 -model_depth 2
-group_norm_groups 2), the 32x32 tree of tests/test_torch_cli.py,
-device cpu, float32.

Tolerances (those of tests/test_torch_cli.py): -mode test segmentation.pt
to 1e-5, AUROC to 1e-6, F1 and accuracy equal (no FOV pixel lies within
1e-4 of 0.5 but the exact ties both packages give, asserted), the same
output tree; base_model_mf's per-size metrics.csv values the same way;
-mode train's size plan equal to JAX's (its output tree:
tests/test_torch_mf_train.py); a converted reference checkpoint's weights
equal."""

import os
import re
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import unet_research_tpu.models.unet as junet
from unet_research_tpu.cli import base_model_mf as jax_bm
from unet_research_tpu.cli import lf_training as jax_lf
from unet_research_tpu.cli import mf_training as jax_mf
from unet_research_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from unet_research_tpu_torch.cli import base_model_mf, common, lf_training, mf_training
from unet_research_tpu_torch.evaluation.metrics import output_files
from unet_research_tpu_torch.models.unet import UNet, canonical_config
from unet_research_tpu_torch.train.checkpoint import load_checkpoint
from unet_research_tpu_torch.utils import convert

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


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX-package checkpoint of the tiny model, its 1x1 head scaled up so
    that the segmentations spread away from 0.5."""
    cfg = junet.canonical_config(**TINY)
    params = junet.UNet(cfg).init(jax.random.PRNGKey(11), jnp.zeros((1, 32, 32, 1)))["params"]
    params = {**params, "head": {**params["head"], "kernel": params["head"]["kernel"] * 4.0}}
    path = tmp_path_factory.mktemp("ckpt") / "model-epoch=04-val_loss=0.50.ckpt"
    return jax_save_checkpoint(str(path), params, meta={"epoch": 4, "val_loss": 0.5})


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


def _assert_metrics_match(out, ref, shape):
    """segmentation.pt to 1e-5, AUROC to 1e-6, F1 and accuracy equal."""
    for i in range(2):
        rel = ("val_images", "tensors", f"image_{i}", "segmentation.pt")
        seg, seg_ref = torch.load(join(out, *rel)).numpy(), torch.load(join(ref, *rel)).numpy()
        assert seg.shape == seg_ref.shape == shape
        np.testing.assert_allclose(seg, seg_ref, atol=1e-5)
        # a pixel whose channels the last ReLU zeroes is exactly 0.5 in both
        # packages (the head has no bias); no other pixel lies near it
        tie = seg_ref == 0.5
        assert np.count_nonzero(np.abs(seg_ref - 0.5) < 1e-4) == np.count_nonzero(tie)
        assert (seg[tie] == 0.5).all()
    jdf = pd.read_csv(join(ref, "val_images", "metrics.csv"))
    pdf = pd.read_csv(join(out, "val_images", "metrics.csv"))
    assert list(pdf.columns) == list(jdf.columns) and len(pdf) == 2
    for col in ("Validation_Image", "F1_Vessel", "Accuracy_Vessel"):
        assert (pdf[col] == jdf[col]).all(), col
    np.testing.assert_allclose(pdf["AUROC_Vessel"], jdf["AUROC_Vessel"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cli,policy,flags", POLICIES, ids=[p for _, p, _ in POLICIES])
def test_testing_mode_matches_jax(aug_data, jax_ckpt, tmp_path, cli, policy, flags):
    argv = (["-mode", "test", "-policy", policy, "-model_path", jax_ckpt, "-data_path", aug_data,
             "-seed", "7"] + flags + SMALL)
    jax_main, port_main = MAINS[cli]
    ref = jax_main(argv + ["-save_path", str(tmp_path / "jax")])
    out = port_main(argv + ["-save_path", str(tmp_path / "port")] + CPU)
    assert _tree(out) == _tree(ref)
    assert sorted(f for f in _tree(out) if not f.endswith("/")) == output_files(2, 2)
    side = 16 if policy in ("lft", "lft-up") else 32
    _assert_metrics_match(out, ref, (1, side, side))


class _Planned(Exception):
    """Raised by a stub trainer's fit with the size plan it was handed."""


@pytest.mark.parametrize("orig,augs", [(3, 2), (2, 2), (4, 3)], ids=["exact", "tiled", "cut"])
@pytest.mark.parametrize("policy", ["uni", "rat", "rsz-rat"])
def test_size_plan_matches_jax(aug_data, tmp_path, monkeypatch, policy, orig, augs):
    """The plan each CLI hands to fit, for a plan of the train set's length
    (6), one to tile and one to truncate."""
    class Stub:
        def fit(self, *args, size_plan=None, **kwargs):
            raise _Planned(np.asarray(size_plan))

    monkeypatch.setattr(jax_mf, "make_trainer", lambda args: Stub())
    monkeypatch.setattr(mf_training, "make_trainer", lambda args: Stub())
    monkeypatch.setattr(common, "fit_and_score",
                        lambda trainer, dest, *data, size_plan=None, **kw: trainer.fit(
                            size_plan=size_plan))
    argv = ["-mode", "train", "-policy", policy, "-data_path", aug_data, "-seed", "5",
            "-orig_train_size", str(orig), "-num_augmentations", str(augs)] + SMALL
    plans = []
    for main, extra in ((jax_mf.main, []), (mf_training.main, CPU)):
        with pytest.raises(_Planned) as got:
            main(argv + ["-save_path", str(tmp_path / f"out{len(plans)}")] + extra)
        plans.append(got.value.args[0])
    assert plans[0].shape == (6,)
    np.testing.assert_array_equal(plans[1], plans[0])
    assert set(plans[1]) <= {-1, 128, 256}


def test_base_model_mf_matches_jax(aug_data, jax_ckpt, tmp_path):
    argv = ["-model_path", jax_ckpt, "-data_path", aug_data, "-height", "16,32",
            "-width", "16,32", "-seed", "3"] + SMALL
    ref = jax_bm.main(argv + ["-save_path", str(tmp_path / "jax")])
    out = base_model_mf.main(argv + ["-save_path", str(tmp_path / "port")] + CPU)
    assert _tree(out) == _tree(ref)
    assert sorted(os.listdir(out)) == ["16x16", "32x32"]
    for size, side in (("16x16", 16), ("32x32", 32)):
        assert sorted(f for f in _tree(join(out, size)) if not f.endswith("/")) == output_files(2, 2)
        _assert_metrics_match(join(out, size), join(ref, size), (1, side, side))
    # one width serves every height; unequal lists raise before writing
    out = base_model_mf.main(["-model_path", jax_ckpt, "-data_path", aug_data, "-height", "16,24",
                              "-width", "32", "-save_path", str(tmp_path / "one")] + SMALL + CPU)
    assert sorted(os.listdir(out)) == ["16x32", "24x32"]
    seg = torch.load(join(out, "24x32", "val_images", "tensors", "image_0", "segmentation.pt"))
    assert tuple(seg.shape) == (1, 24, 32)
    with pytest.raises(ValueError, match="-height has 2"):
        base_model_mf.main(["-model_path", jax_ckpt, "-data_path", aug_data, "-height", "16,24",
                            "-width", "8,8,8", "-save_path", str(tmp_path / "bad")] + SMALL + CPU)
    assert not (tmp_path / "bad").exists()


def test_convert_main(tmp_path):
    """A reference-layout PL .ckpt (the 'model.' prefix of the Lightning
    module) becomes a checkpoint of the port with the same weights."""
    cfg = canonical_config(**TINY)
    ref = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    src = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in ref.items()}, "epoch": 9}, src)
    dst = convert.main([str(src), str(tmp_path / "port.ckpt"), "-filters", "4",
                        "-model_depth", "2", "-group_norm_groups", "2"])
    sd, meta, optimizer = load_checkpoint(dst)
    assert meta == {"converted_from": str(src)} and optimizer is None
    want = convert.load_reference_checkpoint(str(src))
    assert sd.keys() == want.keys() == ref.keys()
    for k in sd:
        assert torch.equal(sd[k], want[k]), k
    UNet(cfg, device="cpu").load_state_dict(sd)
    with pytest.raises(RuntimeError, match="size mismatch"):  # a file of another model
        convert.main([str(src), str(tmp_path / "x.ckpt"), "-filters", "8", "-model_depth", "2",
                      "-group_norm_groups", "2"])
