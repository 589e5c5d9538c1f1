"""The port's scanned epochs (Trainer.train_epoch_scan, TrainerConfig.scan_epochs)
against its per-step fit and against the JAX package's scanned fit, on the CPU,
where the scanned step runs eagerly on the same static buffers that a CUDA
graph of it replays on the card.

Tolerances: the scanned fit against the per-step fit exact (losses,
parameters, momentum, BatchNorm's statistics: one step function, one update),
as are the step tables (site keys, drop probabilities), the device seed
thresholds against the host's and the masks and keep counts of a mask site
given a threshold. TrainState's update against torch.optim.SGD, which rounds
p + (-lr) * v where it writes p - (lr * v): atol 1e-6 + rtol 1e-5. Against
JAX's scanned fit rtol 1e-4, as test_fit_matches_jax (float32 steps whose
differences, <= 1e-5, compound through momentum 0.99).
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import unet_research_tpu.models.unet as junet
from unet_research_tpu.data.dataset import ArrayDataset as JArrayDataset
from unet_research_tpu.train import POLICIES as JPOLICIES
from unet_research_tpu.train import Trainer as JTrainer
from unet_research_tpu.train import TrainerConfig as JTrainerConfig
from unet_research_tpu_torch.data import ArrayDataset
from unet_research_tpu_torch.data.loading import to_device
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops import dropblock as tdb
from unet_research_tpu_torch.ops.cuda.dropblock_kernel import (
    dropblock_mask,
    dropblock_mask_plain,
    seed_threshold,
)
from unet_research_tpu_torch.parallel import make_mesh, multihost_initialize
from unet_research_tpu_torch.train import (
    POLICIES,
    Trainer,
    TrainerConfig,
    load_checkpoint,
    lf_policy,
    make_size_plan,
)
from unet_research_tpu_torch.train import loop as tloop
from unet_research_tpu_torch.train.loop import drop_prob_at
from unet_research_tpu_torch.train.state import TrainState, clip_by_global_norm
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dataset(n=6, h=20, w=24, seed=0, cls=ArrayDataset):
    rng = np.random.default_rng(seed)
    ims = (rng.random((n, h, w, 1)) * 255).astype(np.uint8)
    gts = (rng.random((n, h, w, 1)) > 0.7).astype(np.uint8) * 255
    masks = np.full((n, h, w, 1), 255, np.uint8)
    masks[:, :2] = 0
    return cls(ims, gts, masks)


def _ramp(kind="dependent", nr_steps=9, **kw):
    return tunet.DropBlockConfig(kind=kind, block_size=3, use_scheduler=True,
                                 start_drop_prob=0.0, max_drop_prob=0.2, nr_steps=nr_steps,
                                 mask_impl="kernel", **kw)


def _model(db, seed=1, **overrides):
    cfg = tunet.canonical_config(dropblock=db, **{**SMALL, **overrides})
    return tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


class _DropOnce(tloop.ReduceLROnPlateau):
    """The plateau schedule with a decay forced after the first epoch."""

    def step(self, metric):
        lr = super().step(metric)
        if not getattr(self, "forced", False):
            self.forced = True
            self.lr = lr = lr * 0.1
        return lr


def _fit(tmp_path, name, model_fn, scan, policy="none", **cfg):
    model = model_fn()
    kw = dict(max_epochs=3, lr=0.02, clip_norm=0.5, auto_lr_find=False, seed=5,
              verbose=False, log_gate=4, scan_epochs=scan)
    kw.update(cfg)
    pol = POLICIES[policy] if isinstance(policy, str) else policy
    trainer = Trainer(model, pol, TrainerConfig(**kw), device="cpu")
    calls = []
    scan_fn = trainer.train_epoch_scan
    trainer.train_epoch_scan = lambda *a: calls.append(1) or scan_fn(*a)
    state, hist, keeper = trainer.fit(_dataset(), _dataset(3, seed=1), str(tmp_path / name),
                                      params=model.state_dict())
    return trainer, state, hist, keeper, len(calls)


def _assert_params_equal(a, b):
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


# (a) ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dependent", "independent"])
def test_scanned_fit_matches_per_step_fit(tmp_path, monkeypatch, kind):
    """Dependent or independent DropBlock b=3 ramped over 9 steps (the ramp
    ends inside the second of three 6-step epochs), remat, clip 0.5, a
    plateau decay forced after the first epoch: the scanned fit (3 scanned
    epochs) and the per-step fit give the same losses, lr history, steps
    and parameters."""
    monkeypatch.setattr(tloop, "ReduceLROnPlateau", _DropOnce)

    def model_fn():
        return _model(_ramp(kind), remat=True)

    ts, s_state, s_hist, s_keep, s_calls = _fit(tmp_path, "scan", model_fn, True)
    tp, p_state, p_hist, p_keep, p_calls = _fit(tmp_path, "step", model_fn, False)
    assert (s_calls, p_calls) == (3, 0)
    assert s_state.step == p_state.step == 18
    assert s_hist["lr"] == p_hist["lr"] == [0.02, pytest.approx(0.002), pytest.approx(0.002)]
    for key in ("train_loss_epoch", "val_loss_epoch"):
        assert s_hist[key] == p_hist[key], key
    _assert_params_equal(ts.model, tp.model)
    for a, b in zip(s_state.momentum_buffers(), p_state.momentum_buffers()):
        assert torch.equal(a, b)
    assert os.path.basename(s_keep.best_path) == os.path.basename(p_keep.best_path)
    # the scanned fit leaves its gradients allocated and zero
    assert all(p.grad is not None and not p.grad.any() for p in ts.model.parameters())


def test_scanned_fit_under_a_resize_policy(tmp_path):
    """lft at 16^2 (the model runs on a resized square, so the mask sites'
    sizes come from the policy): scanned and per-step fits agree."""
    def model_fn():
        return _model(_ramp(), up_mode="upsample")

    pol = lf_policy("lft", 16)
    ts, s_state, s_hist, _, s_calls = _fit(tmp_path, "scan", model_fn, True, pol, max_epochs=2)
    tp, p_state, p_hist, _, _ = _fit(tmp_path, "step", model_fn, False, pol, max_epochs=2)
    assert s_calls == 2 and s_state.step == p_state.step == 12
    assert s_hist["train_loss_epoch"] == p_hist["train_loss_epoch"]
    _assert_params_equal(ts.model, tp.model)


# (b) ------------------------------------------------------------------------

def test_scanned_fit_matches_jax_scanned_fit(tmp_path):
    """test_fit_matches_jax with the scan on both sides: two epochs,
    DropBlock off, the same seed and weights."""
    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(kind=None), **SMALL)
    tcfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **SMALL)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    kw = dict(max_epochs=2, lr=0.02, auto_lr_find=False, seed=7, verbose=False, log_gate=4,
              scan_epochs=True)
    jt = JTrainer(junet.UNet(jcfg), JPOLICIES["none"], JTrainerConfig(**kw))
    _, jhist, jkeeper = jt.fit(_dataset(cls=JArrayDataset), _dataset(3, seed=1, cls=JArrayDataset),
                               str(tmp_path / "jax"), params=variables["params"])
    tt = Trainer(tunet.UNet(tcfg, device="cpu"), POLICIES["none"], TrainerConfig(**kw),
                 device="cpu")
    assert tt.scans()
    state, hist, keeper = tt.fit(_dataset(), _dataset(3, seed=1), str(tmp_path / "port"),
                                 params=jax_params_to_state_dict(variables, jcfg))
    assert state.step == 12
    for key in ("train_loss_epoch", "val_loss_epoch"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4)
    assert hist["lr"] == jhist["lr"]
    assert os.path.basename(keeper.best_path) == os.path.basename(jkeeper.best_path)


# (c) ------------------------------------------------------------------------

def test_scanned_fit_batchnorm(tmp_path):
    """norm='batch' with remat (the re-run must not count twice): the running
    statistics after the scanned fit equal the per-step fit's, and the kept
    checkpoint restores its validation loss (the twin of
    tests/test_train.py::test_fit_batchnorm_end_to_end)."""
    def model_fn():
        db = tunet.DropBlockConfig(kind="dependent", block_size=3, use_scheduler=False,
                                   drop_prob=0.05, mask_impl="kernel")
        return _model(db, norm="batch", remat=True)

    ts, _, s_hist, s_keep, s_calls = _fit(tmp_path, "scan", model_fn, True, max_epochs=2)
    tp, _, p_hist, _, _ = _fit(tmp_path, "step", model_fn, False, max_epochs=2)
    assert s_calls == 2
    stats = [(k, v) for k, v in ts.model.state_dict().items() if "running" in k or "tracked" in k]
    assert stats
    ref = tp.model.state_dict()
    for k, v in stats:
        if "tracked" in k:
            assert int(v) == int(ref[k]) == 12, k
        else:
            assert torch.equal(v, ref[k]), k
    assert any(v.abs().max() > 1e-4 for k, v in stats if "mean" in k)
    assert s_hist["val_loss_epoch"] == p_hist["val_loss_epoch"]
    best = ts.validate(load_checkpoint(s_keep.best_path)[0], _dataset(3, seed=1))
    assert best == pytest.approx(s_keep.best_metric, rel=1e-6)


# (d) ------------------------------------------------------------------------

def _recorded_sites(monkeypatch):
    """Record (key words, gamma, (H, W), threshold) at every mask site."""
    seen = []
    inner = tdb._mask_and_keep

    def record(x, key_words, gamma, block_size, impl, offset, threshold=None):
        seen.append((key_words.clone(), gamma, tuple(x.shape[1:3]), threshold))
        return inner(x, key_words, gamma, block_size, impl, offset, threshold)

    monkeypatch.setattr(tdb, "_mask_and_keep", record)
    return seen


def _gamma_fn(kind):
    return (tdb.dropblock_gamma_dependent if kind == "dependent"
            else tdb.dropblock_gamma_independent)


@pytest.mark.parametrize("overrides,policy,hw", [
    ({}, "none", (20, 24)),
    ({"up_mode": "upsample", "connection": "add", "pool_mode": "avg"}, "lft", (20, 24)),
    ({"model_depth": 3, "pool_mode": "conv", "connection": "none"}, "uni", (18, 27)),
])
def test_scan_tables_equal_the_per_step_draws(monkeypatch, overrides, policy, hw):
    """The (K, S, 2) key table and the (K,) drop probabilities equal the keys
    the per-step path draws and drop_prob_at of its steps, step by step along
    a ramp, for several layouts and policies; every mask site's device
    threshold equals seed_threshold of the host gamma at its size."""
    kind = "independent" if policy == "lft" else "dependent"
    db = _ramp(kind, nr_steps=5)
    model = _model(db, **overrides)
    pol = lf_policy("lft", 16) if policy == "lft" else POLICIES[policy]
    ds = _dataset(4, *hw)
    trainer = Trainer(model, pol, TrainerConfig(seed=3, verbose=False), device="cpu")
    trainer.key_generator = torch.Generator().manual_seed(11)
    keys, drop_probs = trainer.step_tables(2, 4)
    sites = model.num_mask_sites()
    assert keys.shape == (4, sites, 2) and drop_probs.dtype == torch.float32
    assert drop_probs.tolist() == [float(drop_prob_at(2 + i, db)) for i in range(4)]

    seen = _recorded_sites(monkeypatch)
    state = TrainState(model, 0.01)
    state.step = 2
    trainer.key_generator = torch.Generator().manual_seed(11)
    data = to_device((ds.images, ds.targets, ds.masks), torch.device("cpu"))
    for i in range(4):
        trainer.train_step_indexed(state, data, i, 0.01)
        step = seen[i * sites:(i + 1) * sites]
        assert torch.equal(torch.stack([s[0] for s in step]), keys[i])
        for _, gamma, (h, w), threshold in step:
            assert gamma is None and threshold.dtype == torch.int64
            host = _gamma_fn(kind)(h, w, db.block_size, drop_prob_at(2 + i, db))
            assert int(threshold) == seed_threshold(host), (i, h, w)
    assert len(seen) == 4 * sites


@pytest.mark.parametrize("kind", ["dependent", "independent"])
@pytest.mark.parametrize("b", [3, 7])
def test_device_gamma_equals_the_host_gamma(kind, b):
    """The gamma functions and seed_threshold on a float32 drop probability
    tensor give the numbers of the host's np.float32 arithmetic, bit for
    bit, over a ramp and the site sizes of a 584x565 model (padded to
    592x576, VALID shrinks, deep levels) and odd sizes."""
    db = tunet.DropBlockConfig(start_drop_prob=0.0, max_drop_prob=0.9, nr_steps=40)
    sizes = [(592, 576), (296, 288), (148, 144), (74, 72), (37, 36), (588, 572), (33, 41),
             (b, b), (b + 1, 2 * b + 3)]
    for step in range(41):
        dp = drop_prob_at(step, db)
        word = torch.tensor(dp, dtype=torch.float32)
        for h, w in sizes:
            host = _gamma_fn(kind)(h, w, b, dp)
            dev = _gamma_fn(kind)(h, w, b, word)
            assert dev.dtype == torch.float32 and dev.item() == float(np.float32(host)), (h, w)
            assert int(seed_threshold(dev)) == seed_threshold(host), (step, h, w)


@pytest.mark.parametrize("kind", ["dependent", "independent"])
@pytest.mark.parametrize("impl", ["elementwise", "kernel"])
def test_threshold_site_equals_the_gamma_site(kind, impl):
    """A mask site given its seed threshold as a tensor draws the gamma
    path's mask and keep counts bit for bit, at every step of a ramp (drop
    probability 0 included) and for b = 3 and 7; K2's plain version too,
    with an int64 and a uint32 word."""
    db = tunet.DropBlockConfig(start_drop_prob=0.0, max_drop_prob=0.3, nr_steps=7)
    fn = tdb.dropblock_dependent if kind == "dependent" else tdb.dropblock_independent
    gamma_fn = (tdb.dropblock_gamma_dependent if kind == "dependent"
                else tdb.dropblock_gamma_independent)
    x = torch.randn((2, 18, 22, 8), generator=torch.Generator().manual_seed(0))
    key = tunet.draw_site_keys(1, torch.Generator().manual_seed(1))[0]
    for b in (3, 7):
        for step in range(8):
            dp = drop_prob_at(step, db)
            thr = torch.tensor(seed_threshold(gamma_fn(18, 22, b, dp)))
            want, want_scale = fn(x, key, dp, b, mask_impl=impl, rescale="defer")
            got, got_scale = fn(x, key, None, b, mask_impl=impl, rescale="defer", threshold=thr)
            assert torch.equal(got, want) and torch.equal(got_scale, want_scale), (b, step)
            assert torch.equal(fn(x, key, None, b, mask_impl=impl, threshold=thr),
                               fn(x, key, dp, b, mask_impl=impl))
            gamma = gamma_fn(18, 22, b, dp)
            ref = dropblock_mask_plain(x.shape, key, gamma, b)
            for word in (thr, thr.reshape(1).to(torch.uint32)):
                for got_mask in (dropblock_mask(x.shape, key, None, b, threshold=word),
                                 dropblock_mask_plain(x.shape, key, None, b, threshold=word)):
                    assert all(torch.equal(g, r) for g, r in zip(got_mask, ref))
    with pytest.raises(ValueError, match="threshold"):
        dropblock_mask(x.shape, key, None, 3, threshold=torch.tensor([1.0]))


def test_threshold_route_rejects_the_fused_kernel():
    """The forward-only fused kernel takes drop_prob as a number, not as a
    device word."""
    model = _model(tunet.DropBlockConfig(kind="dependent", block_size=3, mask_impl="fused"))
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(0))
    with torch.no_grad(), pytest.raises(ValueError, match="fused"):
        model(torch.rand((1, 16, 16, 1)), drop_prob=torch.tensor(0.1), site_keys=keys)


@pytest.mark.parametrize("overrides,hw", [
    ({"same_padding": False}, (60, 68)),
    ({"same_padding": False, "up_mode": "upsample", "model_depth": 1}, (21, 30)),
    ({"model_depth": 3, "connection": "none"}, (33, 41)),
])
def test_device_drop_prob_forward_equals_the_host_one(monkeypatch, overrides, hw):
    """A train-mode forward with the drop probability as a device word gives
    the output of the forward with the same np.float32 number, its mask
    sites a threshold each, VALID convolutions and odd sizes included."""
    model = _model(_ramp(), **overrides)
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(0))
    x = torch.rand((1, *hw, 1), generator=torch.Generator().manual_seed(1))
    dp = drop_prob_at(4, model.cfg.dropblock)
    seen = _recorded_sites(monkeypatch)
    with torch.no_grad():
        host = model(x, drop_prob=dp, site_keys=keys, train=True)
        dev = model(x, drop_prob=torch.tensor(dp), site_keys=keys, train=True)
    sites = model.num_mask_sites()
    assert len(seen) == 2 * sites
    assert all(s[3] is None for s in seen[:sites]) and all(s[1] is None for s in seen[sites:])
    assert [seed_threshold(s[1]) for s in seen[:sites]] == [int(s[3]) for s in seen[sites:]]
    assert torch.equal(dev, host)


# (e) ------------------------------------------------------------------------

def test_device_update_equals_sgd_and_survives_a_checkpoint(tmp_path):
    """TrainState.apply_gradients against torch.optim.SGD plus
    clip_by_global_norm on seeded gradients, over six steps with the
    learning rate changed after three (the last two read the lr_tensor as
    set), clip on; the gradients stay allocated and are zeroed in place; its
    momentum buffers ride a checkpoint and come back in a resumed fit."""
    model_a = _model(tunet.DropBlockConfig(kind=None))
    model_b = _model(tunet.DropBlockConfig(kind=None))
    params_a = [p for p in model_a.parameters() if p.requires_grad]
    sgd = torch.optim.SGD(params_a, lr=0.05, momentum=0.99, dampening=0.0, nesterov=False)
    b = TrainState(model_b, 0.05, clip_norm=0.7)
    rng = np.random.default_rng(0)
    for i, step_lr in enumerate([0.05, 0.05, 0.05, 0.005, 0.005, 0.005]):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.1)
                 for p in params_a]
        for p, g in zip(params_a, grads):
            p.grad = g.clone()
        clip_by_global_norm([p.grad for p in params_a], 0.7)
        for group in sgd.param_groups:
            group["lr"] = step_lr
        sgd.step()
        held = [p.grad for p in b.params]
        for p, g in zip(b.params, grads):
            p.grad.add_(g)
        b.apply_gradients(step_lr if i < 4 else None)
        assert b.lr == step_lr and float(b.lr_tensor) == pytest.approx(step_lr)
        assert all(p.grad is h and not p.grad.any() for p, h in zip(b.params, held))
    assert b.step == 6
    for pa, pb in zip(params_a, b.params):
        torch.testing.assert_close(pb, pa, atol=1e-6, rtol=1e-5)
    for pa, vb in zip(params_a, b.momentum_buffers()):
        torch.testing.assert_close(vb, sgd.state[pa]["momentum_buffer"], atol=1e-6, rtol=1e-5)

    # a fresh state's buffers are zeros: torch's first step (a clone of g)
    fresh = TrainState(_model(tunet.DropBlockConfig(kind=None)), 0.1)
    assert all(v is not None and not v.any() for v in fresh.momentum_buffers())
    g = [torch.ones_like(p) for p in fresh.params]
    clip_by_global_norm(g, 1e9)
    assert all(torch.equal(x, torch.ones_like(x)) for x in g)

    # a scanned fit's checkpoint holds its buffers; a resumed fit reads them
    def model_fn():
        return _model(_ramp())

    ts, state, _, keeper, _ = _fit(tmp_path, "first", model_fn, True, max_epochs=1)
    _, meta, opt = load_checkpoint(keeper.best_path)
    assert meta["step"] == 6
    resumed = {}
    for scan in (True, False):
        tr = Trainer(model_fn(), POLICIES["none"],
                     TrainerConfig(max_epochs=1, lr=0.02, clip_norm=0.5, auto_lr_find=False,
                                   seed=5, verbose=False, scan_epochs=scan), device="cpu")
        st, hist, _ = tr.fit(_dataset(), _dataset(3, seed=1), str(tmp_path / f"r{scan}"),
                             resume_from=keeper.best_path)
        assert hist["train_loss_epoch"] == [] and st.step == 6
        for x, y in zip(st.momentum_buffers(), state.momentum_buffers()):
            assert torch.equal(x, y)
        tr.cfg = dataclasses.replace(tr.cfg, max_epochs=2)
        st, hist, _ = tr.fit(_dataset(), _dataset(3, seed=1), str(tmp_path / f"s{scan}"),
                             resume_from=keeper.best_path)
        assert st.step == 12
        resumed[scan] = (hist, tr.model)
    assert resumed[True][0]["train_loss_epoch"] == resumed[False][0]["train_loss_epoch"]
    _assert_params_equal(resumed[True][1], resumed[False][1])


# (f) ------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", ["default", "off", "size_plan", "train_batch", "anomaly",
                                  "mesh"])
def test_fit_scans_exactly_where_jax_does(tmp_path, case):
    """JAX's use_scan (unet_research_tpu/train/loop.py:296-302): scanned by
    default; a size plan, train_batch 2, detect_anomaly, scan_epochs=False or
    a mesh (a gloo group of one rank) step one at a time."""
    cfg = dict(max_epochs=1, lr=0.01, auto_lr_find=False, seed=1, verbose=False)
    plan, policy, mesh = None, POLICIES["none"], None
    if case == "off":
        cfg["scan_epochs"] = False
    elif case == "size_plan":
        plan, policy = make_size_plan("uni", 2, 3, np.random.default_rng(0)), POLICIES["uni"]
    elif case == "train_batch":
        cfg["train_batch"] = 2
    elif case == "anomaly":
        cfg["detect_anomaly"] = True
    elif case == "mesh":
        multihost_initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
        mesh = make_mesh(device="cpu")
    try:
        trainer = Trainer(_model(_ramp()), policy, TrainerConfig(**cfg), mesh=mesh,
                          device="cpu")
        calls = []
        scan_fn = trainer.train_epoch_scan
        trainer.train_epoch_scan = lambda *a: calls.append(1) or scan_fn(*a)
        state, hist, _ = trainer.fit(_dataset(), _dataset(2, seed=1), str(tmp_path / "mi"),
                                     size_plan=plan)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    scans = case == "default"
    assert trainer.scans(plan) is scans
    assert len(calls) == (1 if scans else 0)
    assert state.step == (3 if case == "train_batch" else 6)
    assert np.isfinite(hist["train_loss_epoch"]).all()


# (g) ------------------------------------------------------------------------

def test_trainer_config_has_every_jax_field():
    ours = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    for f in dataclasses.fields(JTrainerConfig):
        assert f.name in ours, f.name
        assert ours[f.name] == f.default, f.name
    assert ours["scan_epochs"] is True
