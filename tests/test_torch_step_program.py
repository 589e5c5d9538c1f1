"""The port's step programs (train/loop.py::_StepProgram, the twin of JAX's
jitted train_step_indexed with its static size): stepped fits (size plans,
detect_anomaly, scan_epochs=False) and lr_find through the program against
the same runs with program=False (every step from the host), and against
the JAX package's fit under a size plan.

On the CPU the program's step runs eagerly on the same device tables that
a CUDA graph of it replays on the card; `test_the_card_schedule_on_the_cpu`
drives the card's schedule (warm-up steps, one capture per size, replays)
with a stand-in for the graph whose replay runs the step.

Tolerances: program against program=False exact (losses, parameters,
momentum, state.step, the key generator's state, lr_find's suggestion and
number of steps: one step function on the same inputs). Against JAX's fit
rtol 1e-4 on the history, as test_fit_matches_jax (float32 steps whose
differences compound through momentum 0.99). On the card (part (d), marked
`cuda`, skipped without one) a replay against an eager step within the
train-scan tolerances of chip_smoke.py: each step's loss within 2e-3
relative, the parameters within 1e-4 relative L2 (K3's float32 atomics and
cuDNN may order sums differently in two runs). Run it on a card with

    python -m pytest tests/test_torch_step_program.py -q --noconftest -m cuda
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from unet_research_tpu_torch.data import ArrayDataset
from unet_research_tpu_torch.data.loading import to_device
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig, lr_find, make_size_plan
from unet_research_tpu_torch.train import loop as tloop

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


def _ramp(nr_steps=9):
    return tunet.DropBlockConfig(kind="dependent", block_size=3, use_scheduler=True,
                                 start_drop_prob=0.0, max_drop_prob=0.2, nr_steps=nr_steps,
                                 mask_impl="kernel")


def _model(db, seed=1, **overrides):
    cfg = tunet.canonical_config(dropblock=db, **{**SMALL, **overrides})
    return tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _count_advances(monkeypatch) -> list:
    """Record the size of every _StepProgram.advance."""
    seen = []
    inner = tloop._StepProgram.advance

    def advance(self, size=-1):
        seen.append(size)
        return inner(self, size)

    monkeypatch.setattr(tloop._StepProgram, "advance", advance)
    return seen


# (a) the stepped fits ---------------------------------------------------------

FIT_CASES = {
    # policy, size plan, config: every plan holds -1, 256 and 128
    "uni": ("uni", ("uni", 3, 2), {}),
    "rat": ("rat", ("rat", 7, 1), {}),
    "rsz-rat": ("rsz-rat", ("rat", 7, 1), {}),
    "detect_anomaly": ("none", None, {"detect_anomaly": True}),
    "scan_epochs_off": ("none", None, {"scan_epochs": False}),
}


def _fit(tmp_path, case, program, **overrides):
    policy, plan_args, extra = FIT_CASES[case]
    plan = None
    if plan_args is not None:
        plan = make_size_plan(*plan_args, np.random.default_rng(0))
    model = _model(_ramp(), remat=True)
    kw = dict(max_epochs=2, lr=0.02, clip_norm=0.5, auto_lr_find=False, seed=5, verbose=False,
              log_gate=4, **extra)
    kw.update(overrides)
    trainer = Trainer(model, POLICIES[policy], TrainerConfig(**kw), device="cpu", program=program)
    ds = _dataset(6 if plan is None else len(plan))
    state, hist, keeper = trainer.fit(ds, _dataset(3, seed=1),
                                      str(tmp_path / f"{case}_{program}"), size_plan=plan,
                                      params=model.state_dict())
    return trainer, state, hist, keeper, plan


def _assert_same_fit(a, b):
    (ta, sa, ha, ka, _), (tb, sb, hb, kb, _) = a, b
    assert sa.step == sb.step
    np.testing.assert_equal(ha, hb)  # exact; an epoch of one step logs no train loss (nan)
    for (k, x), y in zip(ta.model.state_dict().items(), tb.model.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip(sa.momentum_buffers(), sb.momentum_buffers()):
        assert torch.equal(x, y)
    assert torch.equal(ta.key_generator.get_state(), tb.key_generator.get_state())
    assert os.path.basename(ka.best_path) == os.path.basename(kb.best_path)


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_stepped_fit_through_the_program_equals_host_steps(tmp_path, monkeypatch, case):
    """uni, rat and rsz-rat under make_size_plan's plans (sizes -1, 256 and
    128), detect_anomaly and scan_epochs=False, each with dependent
    DropBlock b=3 ramped over 9 steps (across the epoch boundary), remat and
    clip 0.5, 2 epochs: the fit through the step program and the fit with
    program=False give the same losses, lr history, steps, parameters,
    momentum and key generator state, and no scanned epoch runs."""
    seen = _count_advances(monkeypatch)
    scans = []
    monkeypatch.setattr(Trainer, "train_epoch_scan", lambda *a: scans.append(1))
    stepped = _fit(tmp_path, case, False)
    assert seen == []
    programmed = _fit(tmp_path, case, True)
    plan = programmed[4]
    steps = 2 * (6 if plan is None else len(plan))
    assert seen == ([-1] * steps if plan is None else [int(s) for s in np.tile(plan, 2)])
    if plan is not None:
        assert set(plan.tolist()) == {-1, 128, 256}
    assert scans == [] and programmed[1].step == steps
    _assert_same_fit(programmed, stepped)
    assert all(p.grad is not None and not p.grad.any() for p in programmed[0].model.parameters())
    assert programmed[0]._program is None  # the fit drops its program


def test_detect_anomaly_raises_at_the_step_through_the_program(tmp_path, monkeypatch):
    """A non-finite loss raises FloatingPointError at the step that gave it,
    read after that step, as the host steps read it."""
    real = tloop.masked_rescaled_bce
    calls = []

    def loss_fn(*args, **kw):
        calls.append(1)
        loss = real(*args, **kw)
        return loss * float("nan") if len(calls) == 4 else loss

    monkeypatch.setattr(tloop, "masked_rescaled_bce", loss_fn)
    for program in (True, False):
        calls.clear()
        with pytest.raises(FloatingPointError, match="epoch 0 batch 3"):
            _fit(tmp_path, "detect_anomaly", program)
        assert len(calls) == 4


# (b) lr_find -------------------------------------------------------------------

LR_CASES = {
    # policy, plan, model overrides, lr_find keywords, whether it stops early
    "full": ("none", None, {}, dict(num_training=30), False),
    "uni_plan": ("uni", ("uni", 3, 2), {}, dict(num_training=16), False),
    # no normalisation: at max_lr 100 the loss runs away and the smoothed
    # loss passes 4x its best before the last step
    "diverges": ("none", None, {"norm": None}, dict(num_training=30, max_lr=100.0), True),
}


@pytest.mark.parametrize("case", list(LR_CASES))
def test_lr_find_through_the_program_equals_host_steps(monkeypatch, case):
    """The sweep through its step program against program=False, from one
    set of weights and one key generator: the same losses step by step, the
    same number of steps (fewer than num_training where it diverges), the
    same suggestion, the key generator where the steps that ran leave it,
    and the model's weights put back."""
    policy, plan_args, overrides, kw, stops = LR_CASES[case]
    plan = None
    if plan_args is not None:
        plan = make_size_plan(*plan_args, np.random.default_rng(0))
    ds = _dataset(6 if plan is None else len(plan))
    seen = _count_advances(monkeypatch)
    out = {}
    for program in (False, True):
        model = _model(_ramp(), remat=True, **overrides)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        trainer = Trainer(model, POLICIES[policy], TrainerConfig(seed=3, lr=0.01, verbose=False),
                          device="cpu")
        trainer.key_generator = torch.Generator().manual_seed(11)
        losses = []
        step_fn = trainer.train_step_indexed

        def spy(*args, step_fn=step_fn, losses=losses, **kwargs):
            loss = step_fn(*args, **kwargs)
            losses.append(float(loss))
            return loss

        trainer.train_step_indexed = spy
        lr = lr_find(trainer, None, ds, plan, 4, program=program, **kw)
        out[program] = (lr, losses, trainer.key_generator.get_state())
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert len(seen) == (len(losses) if program else 0)
    (lr_p, losses_p, gen_p), (lr_h, losses_h, gen_h) = out[True], out[False]
    assert losses_p == losses_h and lr_p == lr_h and torch.equal(gen_p, gen_h)
    assert (len(losses_p) < kw["num_training"]) is stops
    assert lr_p != 0.01  # enough points for a suggestion
    if plan is not None:
        assert seen == [int(s) for s in np.resize(plan, kw["num_training"])]


def test_lr_find_follows_the_trainer_and_leaves_the_fit_its_keys(tmp_path, monkeypatch):
    """fit's lr_find takes the trainer's program setting; a fit with the
    sweep (auto_lr_find) gives the same suggestion, history and parameters
    through the programs as with program=False, so the sweep left the key
    generator where the host steps leave it."""
    seen = _count_advances(monkeypatch)
    fits = {}
    for program in (False, True):
        fits[program] = _fit(tmp_path, "uni", program, auto_lr_find=True, max_epochs=1)
        assert len(seen) == (100 + 6 if program else 0)  # the sweep's steps, then the fit's
    _assert_same_fit(fits[True], fits[False])
    assert fits[True][2]["lr"] == fits[False][2]["lr"] != [0.02]


# (c) against JAX -----------------------------------------------------------------

def test_program_stepped_uni_fit_matches_jax(tmp_path, monkeypatch):
    """A uni fit under make_size_plan's plan (sizes -1, 256, 128), DropBlock
    off, through the step program against JAX's Trainer.fit with the same
    plan, weights and seed: the per-epoch losses within rtol 1e-4, the
    same lr history and kept checkpoint.

    One item per size and lr 0.01: at 256^2 and 128^2 this small model's
    steps amplify float32 rounding about tenfold a step, JAX's own steps
    too (a 1e-7 relative change of JAX's weights moves its fourth and fifth
    256^2 step's loss by 2.4e-5 and 5.3e-4), so 12 steps at lr 0.02 part
    both port routes, bit-equal to each other, from JAX by 2.5e-4."""
    import jax
    import jax.numpy as jnp

    import unet_research_tpu.models.unet as junet
    from unet_research_tpu.data.dataset import ArrayDataset as JArrayDataset
    from unet_research_tpu.train import POLICIES as JPOLICIES
    from unet_research_tpu.train import Trainer as JTrainer
    from unet_research_tpu.train import TrainerConfig as JTrainerConfig
    from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(kind=None), **SMALL)
    tcfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **SMALL)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    plan = make_size_plan("uni", 3, 1, np.random.default_rng(0))
    assert sorted(plan.tolist()) == [-1, 128, 256]
    kw = dict(max_epochs=2, lr=0.01, auto_lr_find=False, seed=7, verbose=False, log_gate=2)
    jt = JTrainer(junet.UNet(jcfg), JPOLICIES["uni"], JTrainerConfig(**kw))
    _, jhist, jkeeper = jt.fit(_dataset(3, cls=JArrayDataset),
                               _dataset(3, seed=1, cls=JArrayDataset), str(tmp_path / "jax"),
                               size_plan=plan, params=variables["params"])
    tt = Trainer(tunet.UNet(tcfg, device="cpu"), POLICIES["uni"], TrainerConfig(**kw),
                 device="cpu")
    assert tt.program and not tt.scans(plan)
    advances = _count_advances(monkeypatch)
    state, hist, keeper = tt.fit(_dataset(3), _dataset(3, seed=1), str(tmp_path / "port"),
                                 size_plan=plan, params=jax_params_to_state_dict(variables, jcfg))
    assert state.step == 6 and advances == plan.tolist() * 2
    for key in ("train_loss_epoch", "val_loss_epoch"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4)
    assert hist["lr"] == jhist["lr"]
    assert os.path.basename(keeper.best_path) == os.path.basename(jkeeper.best_path)


# the card's schedule, with a stand-in for the CUDA graph -------------------------

class _FakeGraph:
    """A captured step: its replay runs the step's tensor work eagerly and,
    as a graph, none of its Python (apply_gradients' state.step count)."""

    def __init__(self, step, state):
        self.step, self.state, self.replays = step, state, 0

    def replay(self):
        self.replays += 1
        count = self.state.step
        self.step()
        self.state.step = count


class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("case", ["uni", "one_item_epochs", "lr_find"])
def test_the_card_schedule_on_the_cpu(tmp_path, monkeypatch, case):
    """The card's route through a program, with its graph, streams and
    capture stood in for (the stand-in capture records the step without
    running it, its replay runs it): two eager warm-up steps per size,
    counted across runs, then one capture per size and replays, each
    credited with the capture's launch counts and counted in state.step on
    the host; the numbers are those of program=False. `one_item_epochs`:
    epochs of one step reach the capture at their third step."""
    captures = []
    counts = {"dropblock_mask": 5}

    def capture(step):
        captures.append(_FakeGraph(step, programs[-1].state))
        return captures[-1], dict(counts), 0.25

    monkeypatch.setattr(launches, "capture", capture)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda side: contextlib.nullcontext())
    monkeypatch.setattr(dbk.dropblock_mask, "launches", 0)
    programs = []
    inner_advance = tloop._StepProgram.advance

    def advance(self, size=-1):
        # the card's route, with the tables and the step on the CPU
        if self not in programs:
            programs.append(self)
        self.trainer.device = torch.device("cuda")
        try:
            inner_advance(self, size)
        finally:
            self.trainer.device = torch.device("cpu")

    monkeypatch.setattr(tloop._StepProgram, "advance", advance)

    if case == "lr_find":
        out = {}
        for program in (True, False):
            trainer = Trainer(_model(_ramp(), remat=True), POLICIES["uni"],
                              TrainerConfig(seed=3, verbose=False), device="cpu",
                              program=program)
            plan = make_size_plan("uni", 3, 2, np.random.default_rng(0))
            lr = lr_find(trainer, None, _dataset(len(plan)), plan, 4, num_training=16)
            out[program] = (lr, trainer.key_generator.get_state())
        assert out[True][0] == out[False][0] and torch.equal(out[True][1], out[False][1])
        prog, = programs
        assert sorted(prog.graphs) == [(-1, 1), (128, 1), (256, 1)] and len(captures) == 3
        replays = 16 - 3 * prog.WARMUP
    else:
        fit = _one_item_fit if case == "one_item_epochs" else _fit
        fits = {program: fit(tmp_path, case, program) for program in (True, False)}
        _assert_same_fit(fits[True], fits[False])
        prog, = programs
        sizes = [-1] if case == "one_item_epochs" else [-1, 128, 256]
        assert sorted(prog.graphs) == [(s, 1) for s in sizes] and len(captures) == len(sizes)
        assert all(prog.warm[(s, 1)] == prog.WARMUP for s in sizes)
        replays = fits[True][1].step - len(sizes) * prog.WARMUP
        assert replays == (2 if case == "one_item_epochs" else 6)
    assert sum(g.replays for g in captures) == replays
    assert dbk.dropblock_mask.launches == replays * counts["dropblock_mask"]
    assert all(prog.capture_seconds[s] == 0.25 for s in prog.graphs)


def _one_item_fit(tmp_path, case, program):
    """Four epochs of one item each, stepped (scan_epochs=False)."""
    model = _model(_ramp(nr_steps=3), remat=True)
    cfg = TrainerConfig(max_epochs=4, lr=0.02, clip_norm=0.5, auto_lr_find=False, seed=5,
                        verbose=False, scan_epochs=False)
    trainer = Trainer(model, POLICIES["none"], cfg, device="cpu", program=program)
    state, hist, keeper = trainer.fit(_dataset(1), _dataset(1, seed=1),
                                      str(tmp_path / f"{case}_{program}"),
                                      params=model.state_dict())
    return trainer, state, hist, keeper, None


# (d) on the card ---------------------------------------------------------------------

def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
def test_replays_equal_eager_steps_on_the_card():
    """A uni run of 12 steps over the sizes -1, 256 and 128 in turn (each
    size: two eager warm-up steps, a capture, two replays) through the step
    program against the same steps from the host, from one set of weights
    and one key generator, on the card (pair convs and kernel masks, 64
    filters so that K3 runs), at the train-scan phase's learning rate 1e-3:
    every step's loss within 2e-3 relative, by size, and the parameters
    within 1e-4 relative L2 of each other and well inside the run's own
    movement. (At lr 0.02 the parameters of the two routes part by 2.5e-4:
    the resized steps amplify float32 rounding about tenfold a step, see
    test_program_stepped_uni_fit_matches_jax, and the card's float32
    atomics round differently in every run.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    plan = np.array([-1, 256, 128] * 4)
    ds = _dataset(len(plan), 64, 64)
    start = _model(_ramp(), remat=True, filters=64, group_norm_groups=32).state_dict()
    out = {}
    for program in (True, False):
        model = tunet.UNet(tunet.canonical_config(dropblock=_ramp(), remat=True, filters=64,
                                                  model_depth=2, group_norm_groups=32),
                           device=dev)
        model.load_state_dict(start)
        first = torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])
        trainer = Trainer(model, POLICIES["uni"], TrainerConfig(seed=3, clip_norm=0.5),
                          device=dev, program=program)
        state = trainer.create_state(None, 1e-3)
        data = to_device((ds.images, ds.targets, ds.masks), dev)
        if program:
            prog = tloop._StepProgram(trainer, state, data, len(plan))
            prog.fill(np.arange(len(plan)), 1e-3)
            for size in plan:
                prog.advance(int(size))
            losses = prog.losses.cpu().numpy()
            assert sorted(prog.graphs) == [(-1, 1), (128, 1), (256, 1)]
        else:
            losses = np.array([float(trainer.train_step_indexed(state, data, i, 1e-3, int(s)))
                               for i, s in enumerate(plan)], np.float32)
        params = torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])
        out[program] = (losses, params, state.step)
    (lp, pp, sp), (lh, ph, sh) = out[True], out[False]
    assert sp == sh == len(plan)
    for size in (-1, 256, 128):
        at = plan == size
        rel = np.abs(lp[at] - lh[at]) / np.abs(lh[at])
        assert np.isfinite(lp[at]).all() and rel.max() <= 2e-3, (size, lp[at], lh[at])
    assert _rel_l2(pp, ph) <= 1e-4
    assert _rel_l2(pp, ph) <= 0.1 * _rel_l2(ph, first)
