"""The port's training engine (unet_research_tpu_torch/train/) against the
JAX package's: schedules, checkpoint names and retention, MF size plans,
the DropBlock ramp, Trainer.fit end to end, resume, lr_find, and the guard
on the forward-only fused kernel.

Tolerances: schedules, names, plans and lr_find suggestions exact (the same
Python and numpy arithmetic); the ramp bit-exact against JAX's float32
ramp evaluated op by op, within 1 ulp of the jitted one; fit's epoch
losses rtol 1e-4 (12 float32 steps whose per-step differences, <= 1e-5,
compound through momentum 0.99)."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unet_research_tpu.models.unet as junet
from unet_research_tpu.data.dataset import ArrayDataset as JArrayDataset
from unet_research_tpu.ops.dropblock import linear_drop_prob as jlinear_drop_prob
from unet_research_tpu.train import EarlyStopping as JEarlyStopping
from unet_research_tpu.train import POLICIES as JPOLICIES
from unet_research_tpu.train import ReduceLROnPlateau as JReduceLROnPlateau
from unet_research_tpu.train import Trainer as JTrainer
from unet_research_tpu.train import TrainerConfig as JTrainerConfig
from unet_research_tpu.train import make_size_plan as jmake_size_plan
from unet_research_tpu.train.checkpoint import BestCheckpointKeeper as JKeeper
from unet_research_tpu.train.loop import lr_find as jlr_find
from unet_research_tpu_torch.data import ArrayDataset, batch_iterator
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.parallel import Mesh
from unet_research_tpu_torch.train import (
    POLICIES,
    BestCheckpointKeeper,
    EarlyStopping,
    ReduceLROnPlateau,
    Trainer,
    TrainerConfig,
    find_checkpoint,
    load_checkpoint,
    lr_find,
    make_size_plan,
)
from unet_research_tpu_torch.train.loop import drop_prob_at
from unet_research_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_reference_checkpoint,
)

SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here, and the suite runs
    several test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_plateau_matches_jax(rng):
    metrics = rng.random(60) * 0.5 + 0.1
    metrics[20:40] = 0.1  # a flat stretch: decays, then the min_lr floor
    ours, ref = ReduceLROnPlateau(0.05), JReduceLROnPlateau(0.05)
    for m in metrics:
        assert ours.step(float(m)) == ref.step(float(m))
    with pytest.raises(ValueError):
        ReduceLROnPlateau(0.1, mode="max")


def test_early_stopping_matches_jax(rng):
    seq = list(rng.random(30))
    ours, ref = EarlyStopping(patience=4), JEarlyStopping(patience=4)
    assert [ours.step(v) for v in seq] == [ref.step(v) for v in seq]


def test_keeper_names_and_retention_match_jax(tmp_path):
    ours, ref = BestCheckpointKeeper(str(tmp_path / "t")), JKeeper(str(tmp_path / "j"))
    sd = {"w": torch.ones(3)}
    for epoch, val in enumerate([0.5, 0.6, 0.41, 0.4149, 0.3, 0.3]):
        a = ours.update(epoch, val, sd, meta={"lr": 0.1})
        b = ref.update(epoch, val, {"w": np.ones(3, np.float32)})
        assert (a is None) == (b is None)
        assert a is None or os.path.basename(a) == os.path.basename(b)
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") == [
        "model-epoch=04-val_loss=0.30.ckpt"]
    assert find_checkpoint(str(tmp_path / "t")) == ours.best_path


def test_checkpoint_is_read_by_the_reference_loader(tmp_path):
    """The keeper writes the reference PL .ckpt layout: load_reference_checkpoint
    reads its weights; load_checkpoint also gives meta and optimizer state."""
    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    keeper = BestCheckpointKeeper(str(tmp_path))
    path = keeper.update(3, 0.25, model.state_dict(), meta={"lr": 0.1, "step": 7},
                         optimizer=opt.state_dict())
    sd = load_reference_checkpoint(path)
    assert sd.keys() == model.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    sd2, meta, opt_sd = load_checkpoint(path)
    assert meta == {"epoch": 3, "val_loss": 0.25, "lr": 0.1, "step": 7}
    assert opt_sd["param_groups"][0]["momentum"] == 0.9


@pytest.mark.parametrize("kind,n,aug", [("uni", 14, 3), ("rat", 14, 1), ("rsz-rat", 9, 2)])
def test_size_plan_matches_jax(kind, n, aug):
    ours = make_size_plan(kind, n, aug, np.random.default_rng(5))
    ref = jmake_size_plan(kind, n, aug, np.random.default_rng(5))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("start,stop,n", [(0.0, 0.15, 8), (0.05, 0.2, 500), (0.1, 0.1, 1)])
def test_drop_prob_ramp_is_the_jax_ramp(start, stop, n):
    """The step's drop probability is JAX's float32 ramp: bit for bit against
    its op-by-op evaluation, within one float32 ulp of the jitted step (XLA
    may rewrite the division by the constant)."""
    db = tunet.DropBlockConfig(start_drop_prob=start, max_drop_prob=stop, nr_steps=n)
    ramp = jax.jit(lambda s: jlinear_drop_prob(s, start, stop, n))
    for step in (0, 1, 3, 7, 250, 499, 900):
        ours = drop_prob_at(step, db)
        assert ours.dtype == np.float32
        assert ours == np.float32(jlinear_drop_prob(jnp.asarray(step, jnp.int32), start, stop, n))
        jitted = np.float32(ramp(jnp.asarray(step, jnp.int32)))
        assert abs(ours - jitted) <= np.spacing(jitted)


def _dataset(cls, n=6, h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    ims = (rng.random((n, h, w, 1)) * 255).astype(np.uint8)
    gts = (rng.random((n, h, w, 1)) > 0.7).astype(np.uint8) * 255
    masks = np.full((n, h, w, 1), 255, np.uint8)
    masks[:, :2] = 0
    return cls(ims, gts, masks)


def _model_pair(seed=0):
    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(kind=None), **SMALL)
    tcfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **SMALL)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 1)))
    return jcfg, tcfg, variables["params"], jax_params_to_state_dict(variables, jcfg)


def test_fit_matches_jax(tmp_path):
    """Two epochs, DropBlock off, the same seed and weights: the per-epoch
    train and val losses equal JAX's, and so does the kept checkpoint's
    name; the kept file restores the final validation loss."""
    jcfg, tcfg, params, sd = _model_pair()
    kw = dict(max_epochs=2, lr=0.02, auto_lr_find=False, seed=7, verbose=False, log_gate=4)
    jt = JTrainer(junet.UNet(jcfg), JPOLICIES["none"], JTrainerConfig(**kw))
    _, jhist, jkeeper = jt.fit(_dataset(JArrayDataset), _dataset(JArrayDataset, 3, seed=1),
                               str(tmp_path / "jax"), params=params)
    model = tunet.UNet(tcfg, device="cpu")
    tt = Trainer(model, POLICIES["none"], TrainerConfig(**kw), device="cpu")
    val_ds = _dataset(ArrayDataset, 3, seed=1)
    state, hist, keeper = tt.fit(_dataset(ArrayDataset), val_ds, str(tmp_path / "port"),
                                 params=sd)
    assert state.step == 12
    for key in ("train_loss_epoch", "val_loss_epoch"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4)
    assert hist["lr"] == jhist["lr"]
    assert os.path.basename(keeper.best_path) == os.path.basename(jkeeper.best_path)
    best = tt.validate(load_checkpoint(keeper.best_path)[0], val_ds)
    assert best == pytest.approx(keeper.best_metric, rel=1e-6)
    preds = list(tt.predict(None, val_ds))
    assert len(preds) == 3 and preds[0][1].shape == (1, 20, 24, 1)
    assert np.isfinite(preds[0][1]).all()


def test_resume_restores_weights_momentum_lr_and_step(tmp_path):
    _, tcfg, _, sd = _model_pair()
    kw = dict(lr=0.02, auto_lr_find=False, seed=3, verbose=False)
    tds, vds = _dataset(ArrayDataset), _dataset(ArrayDataset, 2, seed=1)
    first = Trainer(tunet.UNet(tcfg, device="cpu"), POLICIES["none"],
                    TrainerConfig(max_epochs=1, **kw), device="cpu")
    state, _, keeper = first.fit(tds, vds, str(tmp_path / "a"), params=sd)
    saved_sd, meta, _ = load_checkpoint(keeper.best_path)
    assert meta["epoch"] == 0 and meta["step"] == 6 and meta["lr"] == 0.02

    again = Trainer(tunet.UNet(tcfg, device="cpu"), POLICIES["none"],
                    TrainerConfig(max_epochs=1, **kw), device="cpu")
    st, hist, _ = again.fit(tds, vds, str(tmp_path / "b"), resume_from=keeper.best_path)
    assert hist["train_loss_epoch"] == [] and st.step == 6 and st.lr == 0.02
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, saved_sd[k]), k
    for a, b in zip(st.momentum_buffers(), state.momentum_buffers()):
        assert torch.equal(a, b)

    more = Trainer(tunet.UNet(tcfg, device="cpu"), POLICIES["none"],
                   TrainerConfig(max_epochs=2, **kw), device="cpu")
    st2, hist2, _ = more.fit(tds, vds, str(tmp_path / "c"), resume_from=keeper.best_path)
    assert len(hist2["train_loss_epoch"]) == 1 and st2.step == 12


def test_fit_batched_plan_profiler_and_anomaly_check(tmp_path):
    """train_batch 2 through the step program, an MF size plan (unshuffled),
    DropBlock on with the ramp, detect_anomaly and the 'trace' profiler."""
    db = tunet.DropBlockConfig(kind="dependent", block_size=3, nr_steps=4, max_drop_prob=0.2)
    model = tunet.UNet(tunet.canonical_config(dropblock=db, remat=True, **SMALL), device="cpu",
                       generator=torch.Generator().manual_seed(1))
    cfg = TrainerConfig(max_epochs=2, lr=0.01, auto_lr_find=False, seed=2, verbose=False,
                        train_batch=2, detect_anomaly=True, profiler="trace")
    tt = Trainer(model, POLICIES["uni"], cfg, device="cpu")
    plan = make_size_plan("uni", 3, 1, np.random.default_rng(0))
    state, hist, keeper = tt.fit(_dataset(ArrayDataset), _dataset(ArrayDataset, 2, seed=1),
                                 str(tmp_path / "mi"), size_plan=plan)
    assert state.step == 6 and all(np.isfinite(hist["train_loss_epoch"]))
    assert os.path.exists(tmp_path / "profile" / "trace.json")
    assert keeper.best_path is not None


def test_batch_iterator_order_and_shapes():
    ds = _dataset(ArrayDataset, 5)
    out = list(batch_iterator(ds, 2, True, np.random.default_rng(4), device="cpu"))
    order = np.arange(5)
    np.random.default_rng(4).shuffle(order)
    assert [b[0].shape[0] for b in out] == [2, 2, 1]
    got = torch.cat([b[0] for b in out])
    torch.testing.assert_close(got, torch.from_numpy(ds[order][0]), atol=0, rtol=0)


class _Script:
    """Scripted losses for both packages' lr_find through stub trainers."""

    def __init__(self, losses):
        self.losses, self.seen = list(losses), []

    def next(self, lr):
        self.seen.append(float(lr))
        return self.losses[len(self.seen) - 1]


def _jax_stub(script, lr=0.01):
    stub = types.SimpleNamespace(cfg=types.SimpleNamespace(train_batch=1, lr=lr), mesh=None,
                                 policy=types.SimpleNamespace(uses_size_plan=False))
    stub.create_state = lambda params, lr: None
    stub._train_step_indexed = lambda st, ims, gts, masks, oi, lr, key, size: (
        st, jnp.float32(script.next(lr)))
    return stub


def _port_stub(script, lr=0.01):
    stub = types.SimpleNamespace(cfg=types.SimpleNamespace(train_batch=1, lr=lr),
                                 policy=types.SimpleNamespace(uses_size_plan=False),
                                 device=torch.device("cpu"), model=torch.nn.Linear(1, 1),
                                 program=False)
    stub.create_state = lambda params, lr: None
    stub.train_step_indexed = lambda st, data, oi, lr, size: torch.tensor(
        script.next(lr), dtype=torch.float32)
    return stub


def _scripts():
    x = np.arange(60)
    dip = 1.0 - 0.6 * np.exp(-((x - 35) / 8.0) ** 2) + 0.01 * np.sin(x)
    diverge = np.concatenate([1.0 - 0.01 * x[:30], np.full(30, 50.0)])
    nan = np.concatenate([1.0 - 0.005 * x[:25], [np.nan] * 35])
    short = np.concatenate([1.0 - 0.01 * x[:8], [np.inf] * 52])
    return {"dip": dip, "diverge": diverge, "nan": nan, "short": short}


@pytest.mark.parametrize("name", ["dip", "diverge", "nan", "short"])
def test_lr_find_matches_jax_on_scripted_losses(name):
    losses = _scripts()[name]
    ds = _dataset(ArrayDataset, 4)
    jscript, tscript = _Script(losses), _Script(losses)
    ref = jlr_find(_jax_stub(jscript), None, _dataset(JArrayDataset, 4), None,
                   jax.random.PRNGKey(0), 3, num_training=50)
    ours = lr_find(_port_stub(tscript), None, ds, None, 3, num_training=50)
    assert ours == ref
    assert tscript.seen == jscript.seen
    if name == "short":
        assert ours == 0.01  # too few points: the configured lr


def test_lr_find_restores_the_weights():
    model = tunet.UNet(tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None),
                                              **SMALL), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tt = Trainer(model, POLICIES["none"], TrainerConfig(seed=1, verbose=False), device="cpu")
    lr = lr_find(tt, None, _dataset(ArrayDataset, 4), None, 1, num_training=14)
    assert 1e-8 <= lr <= 1.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_fused_route_under_autograd_raises():
    """K1 has no backward: a fused pass that autograd records raises; under
    no_grad it runs, and train=True takes the mask producer instead."""
    cfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind="dependent",
                                                                 mask_impl="fused"), **SMALL)
    model = tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.rand((1, 16, 16, 1), generator=torch.Generator().manual_seed(1))
    keys = tunet.draw_site_keys(model.num_mask_sites(), torch.Generator().manual_seed(2))
    with pytest.raises(RuntimeError, match="forward-only"):
        model(x, drop_prob=0.1, site_keys=keys)
    with torch.no_grad():
        fused = model(x, drop_prob=0.1, site_keys=keys)
    trained = model(x, drop_prob=0.1, site_keys=keys, train=True)
    trained.sum().backward()
    torch.testing.assert_close(trained.detach(), fused, atol=1e-6, rtol=0)
    assert all(p.grad is not None for p in model.parameters())


def test_trainer_rejects_a_mesh_and_a_misplaced_model():
    """A mesh whose size does not divide train_batch (the global batch)
    raises before any step; a model on another device than the trainer's
    raises."""
    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu")
    mesh = Mesh(None, 2, 1, 0, torch.device("cpu"))
    for batch in (1, 3):
        with pytest.raises(ValueError, match="does not divide"):
            Trainer(model, POLICIES["none"], TrainerConfig(train_batch=batch), mesh=mesh,
                    device="cpu")
    assert Trainer(model, POLICIES["none"], TrainerConfig(train_batch=4), mesh=mesh,
                   device="cpu").mesh is mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(model, POLICIES["none"], TrainerConfig())
