"""Two real processes of the port over torch.distributed (gloo, CPU): the
twin of tests/test_multihost.py, plus Trainer.fit and the `--devices N`
CLIs under two ranks, each against one process on the same global batch.

Tolerances: the collectives exact; a data-parallel step's loss rel 2e-5 and
parameters rtol 2e-4 / atol 2e-6 of the one-process step (as
tests/test_multihost.py), the ranks bit-identical; fit's epoch losses 1e-5
(two ranks sum their rows' shares where one process sums the batch);
the CLIs' metrics, segmentations and MC tensors 1e-5 of the one-process
run's, the same tree of files.
"""

import os
import pathlib
import socket
import subprocess
import sys
import types
from os.path import join

import numpy as np
import pytest
import torch

from unet_research_tpu_torch.cli import dropblock_uncertainty, training
from unet_research_tpu_torch.data import ArrayDataset
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig
from unet_research_tpu_torch.train.checkpoint import save_checkpoint
from unet_research_tpu_torch.utils.png import write_png

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)
T_SEED = 1_700_000_000  # rank 0's clock for fit(seed=-1); rank 1's reads later


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = r"""
import sys
import types

import numpy as np
import torch
import torch.distributed as dist

rank, world, port, out_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
from unet_research_tpu_torch.data.loading import shard_batch
from unet_research_tpu_torch.parallel.mesh import (all_gather, broadcast_int, make_mesh,
                                                   multihost_initialize, psum)
sys.path.insert(0, "tests")
import test_torch_multihost as t

multihost_initialize(f"tcp://127.0.0.1:{port}", world, rank)
assert dist.get_backend() == "gloo" and dist.get_world_size() == world
mesh = make_mesh(device="cpu")
assert mesh.shape == {"data": world, "model": 1} and mesh.rank == rank
assert str(mesh.device) == "cpu"
total = psum(torch.tensor([float(rank)]), mesh)
gathered = all_gather(torch.full((1, 2), float(rank)), mesh)
assert gathered.tolist() == [[float(r)] * 2 for r in range(world)], gathered
assert broadcast_int(40 + rank, mesh) == 40
print(f"proc {rank} OK total={float(total)}", flush=True)

out = {}
trainer = t.step_trainer(mesh)
rows = shard_batch(tuple(torch.from_numpy(a) for a in t.step_batch(world)), mesh)
loss = trainer.train_step(trainer.create_state(t.step_weights(rank), 0.05), *rows, 0.05)
out["step"] = {"loss": float(loss), "state_dict": trainer.model.state_dict()}

from unet_research_tpu_torch.train import loop
for seed in (5, -1):
    loop.time = types.SimpleNamespace(time=lambda: t.T_SEED + 1000.0 * rank)
    out[f"fit{seed}"] = t.fit_run(mesh, seed, sys.argv[5])
out["lr_find"] = t.lr_find_run(mesh)
torch.save(out, out_path)
"""


def step_trainer(mesh=None) -> Trainer:
    """The data-parallel step of tests/test_multihost.py: GroupNorm, no
    DropBlock, no remat, global batch of 2 at 32x32."""
    cfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **SMALL)
    model = tunet.UNet(cfg, device="cpu")
    tcfg = TrainerConfig(lr=0.05, auto_lr_find=False, seed=0, verbose=False, train_batch=2)
    return Trainer(model, POLICIES["none"], tcfg, mesh=mesh, device="cpu")


def step_weights(rank: int = 0) -> dict:
    """Seeded weights; a rank other than 0 starts from others (create_state
    hands every rank rank 0's)."""
    cfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **SMALL)
    return tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(rank)).state_dict()


def step_batch(n: int):
    rng = np.random.default_rng(0)
    im = rng.random((n, 32, 32, 1)).astype(np.float32)
    gt = (rng.random((n, 32, 32, 1)) > 0.5).astype(np.float32)
    return im, gt, np.ones((n, 32, 32, 1), np.float32)


def fit_data(n: int, seed: int) -> ArrayDataset:
    rng = np.random.default_rng(seed)
    ims = rng.integers(0, 256, (n, 24, 20, 1), dtype=np.uint8)
    gts = ((rng.random((n, 24, 20, 1)) > 0.7) * 255).astype(np.uint8)
    masks = np.full((n, 24, 20, 1), 255, np.uint8)
    masks[: n // 2, :, :6] = 0  # FOVs that differ between the ranks' rows
    return ArrayDataset(ims, gts, masks)


def _fit_trainer(mesh, seed: int, **kw) -> Trainer:
    db = tunet.DropBlockConfig(kind="dependent", block_size=3, use_scheduler=True,
                               start_drop_prob=0.0, max_drop_prob=0.2, nr_steps=4)
    model = tunet.UNet(tunet.canonical_config(dropblock=db, **SMALL), device="cpu")
    tcfg = TrainerConfig(max_epochs=2, lr=0.05, momentum=0.9, clip_norm=1.0,
                         auto_lr_find=False, train_batch=2, seed=seed, verbose=False, **kw)
    return Trainer(model, POLICIES["none"], tcfg, mesh=mesh, device="cpu")


def fit_run(mesh, seed: int, root: str) -> dict:
    """Trainer.fit of 2 epochs, 4 train items at global batch 2 (DropBlock on,
    shuffled), 3 validation items; returns history, the final weights and
    the checkpoint folder's files."""
    trainer = _fit_trainer(mesh, seed)
    model_info = join(root, f"fit{seed}", "model_info")
    state, history, keeper = trainer.fit(fit_data(4, 1), fit_data(3, 2), model_info)
    files = sorted(os.listdir(model_info)) if os.path.isdir(model_info) else []
    return {"history": history, "state_dict": trainer.model.state_dict(), "step": state.step,
            "files": files, "kept": keeper is not None}


def lr_find_run(mesh) -> dict:
    from unet_research_tpu_torch.train import lr_find

    trainer = _fit_trainer(mesh, 3)
    trainer.model.load_state_dict(step_weights())
    return {"lr": lr_find(trainer, None, fit_data(4, 1), None, 3, num_training=14)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    port, env = _free_port(), {**os.environ, "OMP_NUM_THREADS": "1"}
    outs = [root / f"rank{r}.pt" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2", str(port),
                               str(outs[r]), str(root / f"fits{r}")], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
        assert f"proc {r} OK total=1.0" in log
    return [torch.load(o, weights_only=False) for o in outs], root


def test_two_process_collective_and_step(ranks):
    """multihost_initialize (gloo without a card), a global sum, a gather and
    a broadcast (asserted in the workers), and a data-parallel step of the
    global batch of 2 equal to a one-process step on it."""
    outs, _ = ranks
    a, b = (o["step"] for o in outs)
    assert a["loss"] == b["loss"]
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    trainer = step_trainer()
    loss = trainer.train_step(trainer.create_state(step_weights(), 0.05),
                              *(torch.from_numpy(x) for x in step_batch(2)), 0.05)
    assert a["loss"] == pytest.approx(float(loss), rel=2e-5)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(a["state_dict"][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=k)


@pytest.mark.parametrize("seed", [5, -1])
def test_fit_two_ranks_matches_one_process(ranks, tmp_path, monkeypatch, seed):
    """fit under two ranks against one process at the same global batch and
    seed. seed=-1: each rank's clock gives another seed, and rank 0's is
    broadcast (the one process reads rank 0's clock). The ranks' histories
    and weights are identical; rank 0 alone kept a checkpoint."""
    outs, root = ranks
    a, b = (o[f"fit{seed}"] for o in outs)
    assert a["history"] == b["history"] and a["step"] == b["step"] == 4
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    assert a["kept"] and not b["kept"]
    assert len(a["files"]) == 1 and a["files"][0].startswith("model-epoch=")
    assert not os.path.exists(root / "fits1")

    from unet_research_tpu_torch.train import loop

    monkeypatch.setattr(loop, "time", types.SimpleNamespace(time=lambda: T_SEED))
    ref = fit_run(None, seed, str(tmp_path))
    assert ref["files"] == a["files"]
    for name in ("train_loss_epoch", "val_loss_epoch", "lr"):
        np.testing.assert_allclose(a["history"][name], ref["history"][name], rtol=1e-5,
                                   err_msg=name)
    for k, v in ref["state_dict"].items():
        np.testing.assert_allclose(a["state_dict"][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=k)


def test_lr_find_two_ranks_matches_one_process(ranks):
    """lr_find's probe steps are data-parallel steps: the same suggestion."""
    outs, _ = ranks
    assert outs[0]["lr_find"] == outs[1]["lr_find"] == lr_find_run(None)


# --- the CLIs -----------------------------------------------------------------

CLI_SMALL = ["-filters", "4", "-model_depth", "2", "-group_norm_groups", "2",
             "--auto_lr_find", "False", "-device", "cpu"]


@pytest.fixture(scope="module")
def aug_data(tmp_path_factory):
    """An augmented-layout tree (train 6, val 3, test 2) of 32x32 PNGs whose
    FOV masks differ between images."""
    root = tmp_path_factory.mktemp("aug")
    rng = np.random.default_rng(0)
    for split, n, with_targets in [("train", 6, True), ("val", 3, True), ("test", 2, False)]:
        for kind in ("images", "masks") + (("targets",) if with_targets else ()):
            (root / split / kind).mkdir(parents=True)
        for i in range(n):
            write_png(str(root / split / "images" / f"{i}_image.png"),
                      rng.integers(0, 256, (32, 32)).astype(np.uint8))
            mask = np.full((32, 32), 255, np.uint8)
            mask[: 4 * i] = 0
            write_png(str(root / split / "masks" / f"{i}_mask.png"), mask)
            if with_targets:
                write_png(str(root / split / "targets" / f"{i}_target.png"),
                          ((rng.random((32, 32)) > 0.5) * 255).astype(np.uint8))
    return str(root)


def _tree(root):
    out = set()
    for base, dirs, files in os.walk(root):
        rel = os.path.relpath(base, root)
        out |= {os.path.normpath(join(rel, n)) + "/" for n in dirs}
        out |= {os.path.normpath(join(rel, n)) for n in files}
    return out


def _csv(path):
    return np.genfromtxt(path, delimiter=",", names=True)


def _same_runs(one, two, tensors):
    assert _tree(two) == _tree(one)
    for rel in tensors:
        np.testing.assert_allclose(torch.load(join(two, rel)).numpy(),
                                   torch.load(join(one, rel)).numpy(), atol=1e-5, err_msg=rel)
    got, want = _csv(join(two, *METRICS)), _csv(join(one, *METRICS))
    for name in want.dtype.names:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, err_msg=name)


METRICS = ("statistics", "val_images", "metrics.csv")


def test_training_cli_two_ranks_writes_the_one_process_tree(aug_data, tmp_path, monkeypatch):
    """`training -mode train --devices 2 -train_batch 2 -device cpu` spawns
    two gloo ranks; rank 0 writes the tree of the one-process run."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["-mode", "train", "-data_path", aug_data, "-num_epochs", "2", "-seed", "7",
            "-train_batch", "2"] + CLI_SMALL
    one = training.main(argv + ["-save_path", str(tmp_path / "one")])
    two = training.main(argv + ["-save_path", str(tmp_path / "two"), "--devices", "2"])
    assert two == str(tmp_path / "two")
    assert os.listdir(join(two, "model_info")) == os.listdir(join(one, "model_info"))
    _same_runs(one, two, [join("statistics", "val_images", "tensors", f"image_{i}",
                               "segmentation.pt") for i in range(3)])
    for name in ("train_losses.txt", "validation_losses.txt"):
        got, want = (np.loadtxt(join(run, "statistics", "losses", name)) for run in (two, one))
        assert got.shape == want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)


def test_dropblock_cli_two_ranks_writes_the_one_process_tree(aug_data, tmp_path, monkeypatch):
    """`dropblock_uncertainty --devices 2 -device cpu`: chunks of 4 split over
    the ranks, the 3 saved members and the last member run whole on both."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = tunet.canonical_config(filters=4, model_depth=2, group_norm_groups=2)
    ckpt = save_checkpoint(str(tmp_path / "model-epoch=00-val_loss=0.50.ckpt"),
                           tunet.UNet(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(3)).state_dict())
    argv = ["-model_path", ckpt, "-data_path", aug_data, "-iter_num", "12", "-save_num", "3",
            "-chunk", "4", "-block_size", "3", "-drop_prob", "0.15", "-seed", "3"] + CLI_SMALL
    one = dropblock_uncertainty.main(argv + ["-save_path", str(tmp_path / "one")])
    two = dropblock_uncertainty.main(argv + ["-save_path", str(tmp_path / "two"),
                                             "--devices", "2"])
    assert two == str(tmp_path / "two")
    _same_runs(one, two, [join("tensors", f"image_{i}", f"{n}.pt")
                          for i in range(3) for n in ("mean", "std", "tensors")])
    assert torch.load(join(two, "tensors", "image_0", "std.pt")).max() > 0.01
    with pytest.raises(ValueError, match="does not divide"):
        dropblock_uncertainty.main(argv + ["-save_path", str(tmp_path / "x"), "--devices", "3"])
    assert not os.path.exists(tmp_path / "x")


def test_devices_checks_before_anything_is_read(tmp_path, monkeypatch):
    """The commands whose JAX twins take no mesh refuse --devices 2; on a
    host with one card --devices 2 raises, naming both numbers. Nothing is
    read or written."""
    from unet_research_tpu_torch.cli import rotational_uncertainty

    argv = ["-model_path", str(tmp_path / "m.ckpt"), "-data_path", str(tmp_path / "data"),
            "-save_path", str(tmp_path / "out"), "--devices", "2"]
    with pytest.raises(NotImplementedError, match="runs on one device"):
        rotational_uncertainty.main(argv + ["-device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--devices 2: this host has 1 cards"):
        training.main(["-mode", "train", "-data_path", str(tmp_path / "data"), "-save_path",
                       str(tmp_path / "out"), "-train_batch", "2", "--devices", "2"])
    assert not os.path.exists(tmp_path / "out")
