"""The port's CLIs (unet_research_tpu_torch/cli/) against the JAX package's
on one JAX checkpoint and one dataset: the tree of tests/test_cli.py, a tiny
model (-filters 4 -model_depth 2 -group_norm_groups 2), -device cpu,
float32.

Tolerances: `training -mode test` segmentation.pt to 1e-5 and AUROC to
1e-6, F1 and accuracy equal (no FOV pixel lies within 1e-4 of 0.5 but the
exact ties both packages give, which the test asserts);
`rotational_uncertainty -warp gather` mean and members to 1e-4, std to 2e-4
(the rotational engine's tolerances); at -drop_prob 0
`dropblock_uncertainty` mean and members to 1e-5, std at most 1e-6 in the
port and 2e-6 in JAX (float32 noise). Each pair writes the same tree of files.
The model that cli/common.py builds from the route flags is JAX's, and the
flags refuse a route neither package has."""

import argparse
import dataclasses
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import unet_research_tpu.models.unet as junet
from unet_research_tpu.cli import common as jax_common
from unet_research_tpu.cli import dropblock_uncertainty as jax_db
from unet_research_tpu.cli import rotational_uncertainty as jax_rot
from unet_research_tpu.cli import training as jax_training
from unet_research_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from unet_research_tpu_torch.cli import common, dropblock_uncertainty, rotational_uncertainty, training
from unet_research_tpu_torch.evaluation.metrics import output_files
from unet_research_tpu_torch.models.unet import canonical_config
from unet_research_tpu_torch.train.checkpoint import find_checkpoint
from unet_research_tpu_torch.utils.convert import load_model_checkpoint

SMALL = ["-filters", "4", "-model_depth", "2", "-group_norm_groups", "2",
         "--auto_lr_find", "False"]
CPU = ["-device", "cpu"]


@pytest.fixture(scope="module")
def aug_data(tmp_path_factory):
    """The augmented-layout tree of tests/test_cli.py:21-42."""
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
    """A JAX-package checkpoint of the tiny model: a seeded init whose 1x1
    head is scaled up, so that the segmentations spread away from 0.5."""
    cfg = junet.canonical_config(filters=4, model_depth=2, group_norm_groups=2)
    params = junet.UNet(cfg).init(jax.random.PRNGKey(11), jnp.zeros((1, 32, 32, 1)))["params"]
    params = {**params, "head": {**params["head"], "kernel": params["head"]["kernel"] * 4.0}}
    path = tmp_path_factory.mktemp("ckpt") / "model-epoch=04-val_loss=0.50.ckpt"
    return jax_save_checkpoint(str(path), params, meta={"epoch": 4, "val_loss": 0.5})


def _tree(root):
    out = set()
    for base, dirs, files in os.walk(root):
        rel = os.path.relpath(base, root)
        out |= {os.path.normpath(join(rel, n)) + "/" for n in dirs}
        out |= {os.path.normpath(join(rel, n)) for n in files}
    return out


def _load(*parts):
    return torch.load(join(*parts)).numpy()


def test_testing_mode_matches_jax(aug_data, jax_ckpt, tmp_path):
    argv = ["-mode", "test", "-model_path", jax_ckpt, "-data_path", aug_data, "-seed", "7"] + SMALL
    ref = jax_training.main(argv + ["-save_path", str(tmp_path / "jax")])
    out = training.main(argv + ["-save_path", str(tmp_path / "port")] + CPU)
    assert _tree(out) == _tree(ref)
    assert sorted(f for f in _tree(out) if not f.endswith("/")) == output_files(2, 2)
    for i in range(2):
        seg_ref = _load(ref, "val_images", "tensors", f"image_{i}", "segmentation.pt")
        seg = _load(out, "val_images", "tensors", f"image_{i}", "segmentation.pt")
        np.testing.assert_allclose(seg, seg_ref, atol=1e-5)
        # every pixel is in the FOV (all-255 masks). A pixel whose four
        # channels the last ReLU zeroes is exactly 0.5 in both packages (the
        # head has no bias); no other pixel lies near the threshold
        tie = seg_ref == 0.5
        assert np.count_nonzero(np.abs(seg_ref - 0.5) < 1e-4) == np.count_nonzero(tie)
        assert (seg[tie] == 0.5).all() and 0.05 < seg_ref.std()
    jdf = pd.read_csv(join(ref, "val_images", "metrics.csv"))
    pdf = pd.read_csv(join(out, "val_images", "metrics.csv"))
    assert list(pdf.columns) == list(jdf.columns) and len(pdf) == 2
    assert (pdf["Validation_Image"] == jdf["Validation_Image"]).all()
    assert (pdf["F1_Vessel"] == jdf["F1_Vessel"]).all()
    assert (pdf["Accuracy_Vessel"] == jdf["Accuracy_Vessel"]).all()
    np.testing.assert_allclose(pdf["AUROC_Vessel"], jdf["AUROC_Vessel"], rtol=0, atol=1e-6)
    for i in (1, 2):
        rel = join("test_images", "segmentations", f"{i}.png")
        with Image.open(join(out, rel)) as a, Image.open(join(ref, rel)) as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rotational_gather_matches_jax(aug_data, jax_ckpt, tmp_path):
    argv = ["-model_path", jax_ckpt, "-data_path", aug_data, "-num_iterations", "6",
            "-save_num", "2", "-chunk", "4", "-seed", "3", "-warp", "gather"] + SMALL
    ref = jax_rot.main(argv + ["-save_path", str(tmp_path / "jax")])
    out = rotational_uncertainty.main(argv + ["-save_path", str(tmp_path / "port")] + CPU)
    assert _tree(out) == _tree(ref)
    assert os.path.islink(join(out, "model_ckpt_symlink.ckpt"))
    for i in range(2):
        for name, tol, shape in (("mean", 1e-4, (1, 1, 32, 32)), ("std", 2e-4, (1, 1, 32, 32)),
                                 ("tensors", 1e-4, (2, 1, 1, 32, 32))):
            got, want = _load(out, f"image_{i}", f"{name}.pt"), _load(ref, f"image_{i}", f"{name}.pt")
            assert got.shape == want.shape == shape
            np.testing.assert_allclose(got, want, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def mc_runs(aug_data, jax_ckpt, tmp_path_factory):
    """dropblock_uncertainty at -drop_prob 0 in both packages, and the port
    again with -reuse_tensors."""
    root = tmp_path_factory.mktemp("mc")
    # three batches of 4: at p = 0 members of batches of other sizes differ
    # by the float32 rounding of the CPU convs (up to 1.3e-6 in the port)
    argv = ["-model_path", jax_ckpt, "-data_path", aug_data, "-iter_num", "12", "-save_num", "4",
            "-chunk", "4", "-block_size", "3", "-drop_prob", "0", "-seed", "3"] + SMALL
    return (jax_db.main(argv + ["-save_path", str(root / "jax")]),
            dropblock_uncertainty.main(argv + ["-save_path", str(root / "port")] + CPU),
            dropblock_uncertainty.main(argv + ["-save_path", str(root / "reuse"),
                                               "-reuse_tensors"] + CPU))


def test_dropblock_at_p0_matches_jax(mc_runs):
    ref, out, _ = mc_runs
    assert _tree(out) == _tree(ref)
    files = {f for f in _tree(out) if f.startswith("statistics/") and not f.endswith("/")}
    assert sorted(f[len("statistics/"):] for f in files) == output_files(2, 0, disable_test=True)
    for i in range(2):
        folder = ("tensors", f"image_{i}")
        for name, shape in (("mean", (1, 1, 32, 32)), ("tensors", (4, 1, 1, 32, 32))):
            got, want = _load(out, *folder, f"{name}.pt"), _load(ref, *folder, f"{name}.pt")
            assert got.shape == want.shape == shape
            np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)
        # float32 noise only: the JAX engine under the tests' XLA -O0 reads
        # 1.1e-6 here, the port 0
        assert _load(out, *folder, "std.pt").max() <= 1e-6
        assert _load(ref, *folder, "std.pt").max() <= 2e-6


def test_reuse_tensors_scores_the_phase1_means(mc_runs):
    _, out, reuse = mc_runs
    for rel in ("statistics/val_images/metrics.csv",
                "statistics/val_images/tensors/image_1/segmentation.pt"):
        with open(join(out, rel), "rb") as a, open(join(reuse, rel), "rb") as b:
            if rel.endswith(".csv"):
                assert a.read() == b.read()
            else:
                assert torch.equal(torch.load(a), torch.load(b))


@pytest.fixture(scope="module")
def trained(aug_data, tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    return training.main(["-mode", "train", "-data_path", aug_data, "-save_path",
                          str(out / "bm"), "-num_epochs", "1", "-seed", "7"] + SMALL + CPU)


def test_training_output_contract(trained):
    """What tests/test_cli.py:57-77 asserts of the JAX CLI."""
    ckpts = os.listdir(join(trained, "model_info"))
    assert len(ckpts) == 1 and ckpts[0].startswith("model-epoch=")
    stats = join(trained, "statistics")
    assert sorted(f for f in _tree(stats) if not f.endswith("/")) == output_files(2, 2)
    df = pd.read_csv(join(stats, "val_images", "metrics.csv"))
    assert list(df.columns) == ["Validation_Image", "F1_Vessel", "AUROC_Vessel", "Accuracy_Vessel"]
    assert len(df) == 2 and np.isfinite(df.to_numpy()).all()
    seg = torch.load(join(stats, "val_images", "tensors", "image_0", "segmentation.pt"))
    assert tuple(seg.shape) == (1, 32, 32)
    sd, meta = load_model_checkpoint(find_checkpoint(join(trained, "model_info")),
                                     canonical_config(filters=4, model_depth=2, group_norm_groups=2))
    assert meta["epoch"] == 0 and "down_blocks.0.0.0.weight" in sd


def test_resume_and_device_flags(aug_data, jax_ckpt, trained, tmp_path):
    base = ["-mode", "train", "-data_path", aug_data, "-num_epochs", "1", "-seed", "7"] + SMALL
    with pytest.raises(ValueError, match="optimizer"):
        training.main(base + ["-save_path", str(tmp_path / "a"), "-resume_from", jax_ckpt] + CPU)
    # a global batch of 1 does not divide over 2 data-parallel ranks
    with pytest.raises(ValueError, match="does not divide"):
        training.main(base + ["-save_path", str(tmp_path / "b"), "--devices", "2",
                              "-train_batch", "1"] + CPU)
    assert not os.path.exists(tmp_path / "a") and not os.path.exists(tmp_path / "b")
    # the port resumes from its own checkpoint: one more epoch after epoch 0
    ckpt = find_checkpoint(join(trained, "model_info"))
    out = training.main(base + ["-save_path", str(tmp_path / "c"), "-num_epochs", "2",
                                "-resume_from", ckpt] + CPU)
    assert os.listdir(join(out, "model_info"))[0].startswith("model-epoch=01")


@pytest.mark.parametrize("conv,mask", [("pair", "fused"), ("xla", "elementwise"),
                                       ("pair", "kernel")], ids=lambda v: v)
def test_network_config_matches_jax(conv, mask):
    """dropblock_uncertainty's model under -conv_impl / -mask_impl, built by
    the port's cli/common.py and by JAX's from the same flags: the same
    configuration, xla being cuDNN (the port's conv_impl='torch')."""
    args = dropblock_uncertainty.build_parser().parse_args(
        ["-model_path", "m", "-data_path", "d", "-save_path", "s", "-conv_impl", conv,
         "-mask_impl", mask, "--precision", "bf16", *SMALL[:6], *CPU])
    kw = dict(dropblock_kind="dependent", use_scheduler=False, drop_prob=args.drop_prob)
    ours = dataclasses.asdict(common.build_network(args, **kw).cfg)
    theirs = dataclasses.asdict(jax_common.build_unet(args, **kw).cfg)
    assert set(ours) == set(theirs)
    assert ours.pop("dtype") == torch.bfloat16 and theirs.pop("dtype") == jnp.bfloat16
    assert ours.pop("conv_impl") == common.CONV_IMPLS[theirs.pop("conv_impl")]
    assert ours == theirs


@pytest.mark.parametrize("flag,route", [("-conv_impl", "mosaic"), ("-conv_impl", "torch"),
                                        ("-mask_impl", "pallas")])
def test_route_flags_refuse_unknown_routes(flag, route, capsys):
    parser = argparse.ArgumentParser()
    common.add_arch_args(parser)
    with pytest.raises(SystemExit):
        parser.parse_args([flag, route])
    assert "invalid choice" in capsys.readouterr().err
