"""The port's forward programs (train/loop.py::ForwardProgram, the twin of
JAX's jitted eval_step and predict_step) and its step programs at
train_batch > 1 (the twin of the jitted train_step on batch_iterator's
batches): Trainer.validate, Trainer.predict, a fit's validation,
base_model_mf's predict_at / evaluate_at, and a fit and an lr_find at
train_batch 2 with a partial last batch, against the JAX package and
against the same calls with program=False (every forward and step from the
host).

On the CPU a program runs eagerly; `test_the_card_schedule_on_the_cpu`
drives the card's schedule (one eager warm-up forward and one capture per
(role, shape), two warm-up steps and one capture per (size, rows),
replays) with a stand-in for the graph whose replay runs the recorded
call.

Tolerances: against JAX, validation losses and predictions within 1e-5
(the model's tolerance: float32 forwards of the same weights); the fit's
history and lr_find's per-step losses within 2e-6 + 1e-4 relative (the
train step's, float32 steps compounding through momentum 0.99), the same
lr history, kept checkpoint and lr_find suggestion. Program against
program=False exact (the same function on the same inputs). On the card
(part (7), marked `cuda`, skipped without one) replays against eager
forwards within 2e-3 of the outputs' largest magnitude, and a batched fit
within the train-step-program bounds of chip_smoke.py (losses 2e-3
relative, parameters 1e-4 relative L2; K3's float32 atomics order sums
differently in two runs). Run it on a card with

    python -m pytest tests/test_torch_eval_program.py -q --noconftest -m cuda
"""

import contextlib
import gc
import os
import types
import weakref

import numpy as np
import pytest
import torch

from unet_research_tpu_torch.cli import base_model_mf
from unet_research_tpu_torch.data import ArrayDataset
from unet_research_tpu_torch.data.loading import to_device
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.cuda import pair_conv as pc
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig, lf_policy, lr_find
from unet_research_tpu_torch.train import loop as tloop
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)
LF_SIZE = 16
POLICY_KINDS = ("none", "uni", "lft", "hft")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dataset(cls, n=3, h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    ims = (rng.random((n, h, w, 1)) * 255).astype(np.uint8)
    gts = (rng.random((n, h, w, 1)) > 0.7).astype(np.uint8) * 255
    masks = np.full((n, h, w, 1), 255, np.uint8)
    masks[:, :2] = 0
    return cls(ims, gts, masks)


def _jax():
    """The JAX package's pieces, imported when a test runs: the card's
    machine, where part (7) runs, has no jax."""
    import jax
    import jax.numpy as jnp

    import unet_research_tpu.models.unet as junet
    from unet_research_tpu import train
    from unet_research_tpu.cli import base_model_mf as jbase_model_mf
    from unet_research_tpu.data.dataset import ArrayDataset
    from unet_research_tpu.data.loading import batch_iterator
    from unet_research_tpu.train.loop import lr_find
    from unet_research_tpu.train.policies import lf_policy
    return types.SimpleNamespace(jax=jax, jnp=jnp, unet=junet, base_model_mf=jbase_model_mf,
                                 ArrayDataset=ArrayDataset, batch_iterator=batch_iterator,
                                 POLICIES=train.POLICIES, Trainer=train.Trainer,
                                 TrainerConfig=train.TrainerConfig, lf_policy=lf_policy,
                                 lr_find=lr_find)


def _policies(kind):
    J = _jax()
    if kind in ("lft", "hft"):
        return J.lf_policy(kind, LF_SIZE), lf_policy(kind, LF_SIZE)
    return J.POLICIES[kind], POLICIES[kind]


def _model_pair(seed=0):
    """The JAX model's config and init, the port's config and the init as
    its state_dict, DropBlock off."""
    J = _jax()
    jcfg = J.unet.canonical_config(dropblock=J.unet.DropBlockConfig(kind=None), **SMALL)
    tcfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **SMALL)
    variables = J.unet.UNet(jcfg).init(J.jax.random.PRNGKey(seed), J.jnp.zeros((1, 32, 32, 1)))
    return jcfg, tcfg, variables["params"], jax_params_to_state_dict(variables, jcfg)


def _predictions(gen) -> list:
    """predict's yields with each array copied as it comes: on the card's
    route an output is the graph's, valid until the next forward."""
    return [(i, *(np.array(a) for a in arrays)) for i, *arrays in gen]


def _assert_same_predictions(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0]
        for u, v in zip(x[1:], y[1:]):
            np.testing.assert_array_equal(u, v)


# (1) validate and predict ------------------------------------------------------

def _port_forwards(tcfg, sd, policy, val_ds, program):
    """validate, the fit's validation at val_batch 2 and predict of one
    port trainer."""
    tt = Trainer(tunet.UNet(tcfg, device="cpu"), policy, TrainerConfig(verbose=False),
                 device="cpu", program=program)
    val1 = tt.validate(sd, val_ds)
    val2 = tt._mean_val_loss(val_ds, 2)
    preds = _predictions(tt.predict(None, val_ds))
    return val1, val2, preds


@pytest.mark.parametrize("kind", POLICY_KINDS)
def test_validate_and_predict_match_jax(kind):
    """Under none, uni, lft and hft on an odd validation split (3 images):
    Trainer.validate (val_batch 1) and the fit's validation at val_batch 2
    (batches of 2 and 1) equal JAX's validate and its fit's mean of
    eval_step over batch_iterator's batches within 1e-5; predict's four
    outputs equal JAX's; the program route is bit-equal to program=False."""
    J = _jax()
    jcfg, tcfg, params, sd = _model_pair()
    jpolicy, policy = _policies(kind)
    jval = _dataset(J.ArrayDataset, 3, seed=1)
    jt = J.Trainer(J.unet.UNet(jcfg), jpolicy, J.TrainerConfig(verbose=False))
    jval1 = jt.validate(params, jval)
    jval2 = float(np.mean([jt._eval_step(params, None, im, gt, mask)
                           for im, gt, mask in J.batch_iterator(jval, 2, False)]))
    jpreds = list(jt.predict(params, jval))

    val_ds = _dataset(ArrayDataset, 3, seed=1)
    val1, val2, preds = _port_forwards(tcfg, sd, policy, val_ds, True)
    np.testing.assert_allclose([val1, val2], [jval1, jval2], rtol=0, atol=1e-5)
    assert val1 != val2  # the batch of 2 weighs its images differently
    assert len(preds) == len(jpreds) == 3
    for ours, theirs in zip(preds, jpreds):
        assert ours[0] == theirs[0]
        for a, b in zip(ours[1:], theirs[1:]):
            assert a.shape == np.asarray(b).shape
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    if kind == "lft":
        assert preds[0][1].shape == (1, LF_SIZE, LF_SIZE, 1)

    host = _port_forwards(tcfg, sd, policy, val_ds, False)
    assert host[:2] == (val1, val2)
    _assert_same_predictions(host[2], preds)


# (2) base_model_mf ---------------------------------------------------------------

def _collect(predict, val_ds, test_ds, out_dir, *args, **kwargs):
    """final_test_metrics' stand-in: both splits' predictions."""
    return [_predictions(predict(val_ds)), _predictions(predict(test_ds))]


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_predict_at_matches_jax(tmp_path, monkeypatch, hw):
    """base_model_mf's evaluate_at at h x w (the val, then the test split,
    through one forward program) against the JAX evaluate_at's jitted
    predict_step within 1e-5; predict_at, evaluate_at with program=False
    and predict_at with its own program bit-equal."""
    h, w = hw
    J = _jax()
    jcfg, tcfg, params, sd = _model_pair()
    monkeypatch.setattr(J.base_model_mf, "final_test_metrics", _collect)
    monkeypatch.setattr(base_model_mf, "final_test_metrics", _collect)
    jout = J.base_model_mf.evaluate_at(J.unet.UNet(jcfg), params,
                                       _dataset(J.ArrayDataset, 3, seed=1),
                                       _dataset(J.ArrayDataset, 2, seed=2), h, w,
                                       str(tmp_path / "jax"))
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(sd)
    val_ds, test_ds = _dataset(ArrayDataset, 3, seed=1), _dataset(ArrayDataset, 2, seed=2)
    out = base_model_mf.evaluate_at(model, val_ds, test_ds, h, w, str(tmp_path / "port"))
    for ours, theirs in zip(out, jout):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a[0] == b[0] and a[1].shape == (1, h, w, 1)
            for x, y in zip(a[1:], b[1:]):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-5)
    host = base_model_mf.evaluate_at(model, val_ds, test_ds, h, w, str(tmp_path / "host"),
                                     program=False)
    for ours, theirs in zip(out, host):
        _assert_same_predictions(ours, theirs)
    for program in (True, False):
        _assert_same_predictions(
            _predictions(base_model_mf.predict_at(model, val_ds, h, w, program=program)), out[0])


# (3) train_batch 2 ---------------------------------------------------------------

BATCHED = dict(max_epochs=2, lr=0.02, auto_lr_find=False, seed=7, verbose=False, log_gate=2,
               train_batch=2, val_batch=2)


def _port_fit(tmp_path, tcfg, sd, program, tag, **overrides):
    model = tunet.UNet(tcfg, device="cpu")
    tt = Trainer(model, POLICIES["none"], TrainerConfig(**{**BATCHED, **overrides}),
                 device="cpu", program=program)
    state, hist, keeper = tt.fit(_dataset(ArrayDataset, 5), _dataset(ArrayDataset, 3, seed=1),
                                 str(tmp_path / tag), params=sd)
    return tt, state, hist, keeper


def _assert_same_fit(a, b):
    (ta, sa, ha, ka), (tb, sb, hb, kb) = a, b
    assert sa.step == sb.step
    np.testing.assert_equal(ha, hb)
    for (k, x), y in zip(ta.model.state_dict().items(), tb.model.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip(sa.momentum_buffers(), sb.momentum_buffers()):
        assert torch.equal(x, y)
    assert torch.equal(ta.key_generator.get_state(), tb.key_generator.get_state())
    assert os.path.basename(ka.best_path) == os.path.basename(kb.best_path)


def test_batched_fit_matches_jax(tmp_path, monkeypatch):
    """A fit of 2 epochs at train_batch 2 and val_batch 2 over 5 training
    and 3 validation images (batches of 2, 2, 1 and 2, 1), DropBlock off,
    from JAX's weights and seed: every step through the step program on
    the rows batch_iterator gives, the history within 2e-6 + 1e-4 relative
    of JAX's fit, the same lr history and kept checkpoint; bit-equal to the
    same fit with program=False, whose steps take batch_iterator's host
    batches."""
    J = _jax()
    jcfg, tcfg, params, sd = _model_pair()
    jt = J.Trainer(J.unet.UNet(jcfg), J.POLICIES["none"], J.TrainerConfig(**BATCHED))
    _, jhist, jkeeper = jt.fit(_dataset(J.ArrayDataset, 5), _dataset(J.ArrayDataset, 3, seed=1),
                               str(tmp_path / "jax"), params=params)
    rows = []
    inner = tloop._StepProgram.advance

    def advance(self, size=-1):
        rows.append(self.rows[self.at])
        return inner(self, size)

    monkeypatch.setattr(tloop._StepProgram, "advance", advance)
    programmed = _port_fit(tmp_path, tcfg, sd, True, "port")
    assert rows == [2, 2, 1] * 2 and programmed[1].step == 6
    for key in ("train_loss_epoch", "val_loss_epoch"):
        np.testing.assert_allclose(programmed[2][key], jhist[key], rtol=1e-4, atol=2e-6)
    assert programmed[2]["lr"] == jhist["lr"]
    assert os.path.basename(programmed[3].best_path) == os.path.basename(jkeeper.best_path)
    assert programmed[0]._program is None and programmed[0]._forward is None
    rows.clear()
    _assert_same_fit(programmed, _port_fit(tmp_path, tcfg, sd, False, "host"))
    assert rows == []


def _spy_losses(obj, name) -> list:
    """Record the loss of every call of obj.<name> (a port step returning
    the loss, or a JAX step returning (state, loss))."""
    seen, inner = [], getattr(obj, name)

    def spy(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(float(out[1] if isinstance(out, tuple) else out))
        return out

    setattr(obj, name, spy)
    return seen


def test_batched_lr_find_matches_jax():
    """lr_find's 30 steps at train_batch 2 over 5 images (passes of 2, 2 and
    1 rows) from JAX's weights: each step's loss within 2e-6 + 1e-4
    relative of JAX's sweep and the same suggestion; through its step
    program bit-equal to program=False (the same losses, suggestion and
    weights put back)."""
    J = _jax()
    jcfg, tcfg, params, sd = _model_pair()
    cfg = dict(lr=0.01, seed=3, verbose=False, train_batch=2)
    jt = J.Trainer(J.unet.UNet(jcfg), J.POLICIES["none"], J.TrainerConfig(**cfg))
    jlosses = _spy_losses(jt, "_train_step")
    jlr = J.lr_find(jt, params, _dataset(J.ArrayDataset, 5), None, J.jax.random.PRNGKey(3), 3,
                    num_training=30)
    out = {}
    for program in (True, False):
        model = tunet.UNet(tcfg, device="cpu")
        model.load_state_dict(sd)
        tt = Trainer(model, POLICIES["none"], TrainerConfig(**cfg), device="cpu")
        losses = _spy_losses(tt, "train_step_indexed" if program else "train_step")
        lr = lr_find(tt, None, _dataset(ArrayDataset, 5), None, 3, num_training=30,
                     program=program)
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), k
        out[program] = (lr, losses)
    assert out[True] == out[False]
    lr, losses = out[True]
    assert len(losses) == len(jlosses) and lr == jlr != 0.01
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=2e-6)


# (5) the card's schedule, with a stand-in for the CUDA graph -----------------------

class _FakeGraph:
    """A captured call: its replay runs the recorded call eagerly and, as a
    graph, none of its Python (apply_gradients' state.step count)."""

    def __init__(self, call, state=None):
        self.call, self.state, self.replays = call, state, 0

    def replay(self):
        self.replays += 1
        count = None if self.state is None else self.state.step
        self.call()
        if self.state is not None:
            self.state.step = count


class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


@contextlib.contextmanager
def _card_schedule(monkeypatch, fail: bool = False):
    """The card's route through both kinds of program with their tensors on
    the CPU: graphs, streams and capture stood in for (the stand-in capture
    records the call without running it, unless `fail`, when it raises as
    a refused capture does). Yields {"forward": [...], "step": [...],
    "captures": [...]}: the programs that ran (the forward programs that
    capture) and the stand-in graphs."""
    seen = {"forward": [], "step": [], "captures": []}
    stepping = []  # the step program inside advance, if any

    def capture(call):
        if fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        state = stepping[-1].state if stepping else None
        seen["captures"].append(_FakeGraph(call, state))
        counts = {"dropblock_mask": 5} if stepping else {"conv3x3_pair": 3}
        return seen["captures"][-1], counts, 0.25

    monkeypatch.setattr(launches, "capture", capture)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda side: contextlib.nullcontext())
    monkeypatch.setattr(pc.conv3x3_pair, "launches", 0)
    monkeypatch.setattr(dbk.dropblock_mask, "launches", 0)
    forward_call, advance = tloop.ForwardProgram.__call__, tloop._StepProgram.advance

    def forward_on_card(self, *args):
        if self.captures and self not in seen["forward"]:
            seen["forward"].append(self)
        self.device = torch.device("cuda")
        try:
            return forward_call(self, *args)
        finally:
            self.device = torch.device("cpu")

    def advance_on_card(self, size=-1):
        if self not in seen["step"]:
            seen["step"].append(self)
        self.trainer.device = torch.device("cuda")
        stepping.append(self)
        try:
            advance(self, size)
        finally:
            stepping.pop()
            self.trainer.device = torch.device("cpu")

    monkeypatch.setattr(tloop.ForwardProgram, "__call__", forward_on_card)
    monkeypatch.setattr(tloop._StepProgram, "advance", advance_on_card)
    yield seen


def _shapes(rows, h=20, w=24):
    return tuple((rows, h, w, 1) for _ in range(3))


def test_the_card_schedule_on_the_cpu(tmp_path, monkeypatch):
    """A batched fit (3 epochs at train_batch 2 and val_batch 2: steps of 2,
    2, 1 rows, validation batches of 2 and 1), predict after it and
    lr_find's 30 steps at train_batch 2, with DropBlock ramped, on the
    card's route: each (role, shape) forward runs once eagerly, then is
    captured once and replayed; each (size, rows) step runs twice eagerly,
    then is captured once and replayed, the partial batch with a graph of
    its own; each replay is credited with its capture's launch counts; the
    numbers are program=False's."""
    jcfg, tcfg, params, sd = _model_pair()
    db = tunet.DropBlockConfig(kind="dependent", block_size=3, max_drop_prob=0.2, nr_steps=9,
                               mask_impl="kernel")
    tcfg = tunet.canonical_config(dropblock=db, remat=True, **SMALL)
    val_ds = _dataset(ArrayDataset, 3, seed=1)
    fits, preds = {}, {}
    with _card_schedule(monkeypatch) as seen:
        for program in (True, False):
            fits[program] = _port_fit(tmp_path, tcfg, sd, program, f"fit_{program}",
                                      max_epochs=3)
            preds[program] = _predictions(fits[program][0].predict(None, val_ds))
        _assert_same_fit(fits[True], fits[False])
        _assert_same_predictions(preds[True], preds[False])
        (val_prog, predict_prog), (step_prog,) = seen["forward"], seen["step"]
        assert sorted(val_prog.graphs) == [("val", _shapes(1)), ("val", _shapes(2))]
        assert list(predict_prog.graphs) == [("predict", _shapes(1))]
        for prog in (val_prog, predict_prog):
            assert all(prog.warm[key] == prog.WARMUP == 1 for key in prog.graphs)
            assert all(prog.capture_seconds[key] == 0.25 for key in prog.graphs)
        assert sorted(step_prog.graphs) == [(-1, 1), (-1, 2)]
        assert all(step_prog.warm[key] == step_prog.WARMUP for key in step_prog.graphs)
        forward_replays = 2 + 2 + 2  # each validation shape in epochs 2-3, predict's images 2-3
        step_replays = 9 - 2 * 2  # 3 epochs of 2, 2, 1 rows
        replays = {id(g): g.replays for g in seen["captures"]}
        assert sum(replays.values()) == forward_replays + step_replays
        assert pc.conv3x3_pair.launches == 3 * forward_replays
        assert dbk.dropblock_mask.launches == 5 * step_replays

        seen["step"].clear()
        suggestions = []
        for program in (True, False):
            model = tunet.UNet(tcfg, device="cpu")
            trainer = Trainer(model, POLICIES["none"],
                              TrainerConfig(seed=3, verbose=False, train_batch=2), device="cpu",
                              program=program)
            suggestions.append((lr_find(trainer, sd, _dataset(ArrayDataset, 5), None, 4,
                                        num_training=30),
                                trainer.key_generator.get_state()))
        assert suggestions[0][0] == suggestions[1][0] != 1e-3
        assert torch.equal(suggestions[0][1], suggestions[1][1])
        sweep, = seen["step"]
        assert sorted(sweep.graphs) == [(-1, 1), (-1, 2)] and sweep.rows == [2, 2, 1] * 10


def test_predict_at_on_the_card_schedule(tmp_path, monkeypatch):
    """evaluate_at's val and test forwards (5 images of one shape) share
    one program: a warm-up forward, then one capture and a replay for each
    later image; the numbers are program=False's."""
    jcfg, tcfg, params, sd = _model_pair()
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(sd)
    monkeypatch.setattr(base_model_mf, "final_test_metrics", _collect)
    val_ds, test_ds = _dataset(ArrayDataset, 3, seed=1), _dataset(ArrayDataset, 2, seed=2)
    with _card_schedule(monkeypatch) as seen:
        out = base_model_mf.evaluate_at(model, val_ds, test_ds, 16, 16, str(tmp_path / "a"))
        host = base_model_mf.evaluate_at(model, val_ds, test_ds, 16, 16, str(tmp_path / "b"),
                                         program=False)
        prog, = seen["forward"]
        assert list(prog.graphs) == [("predict", _shapes(1))]
        graph, = seen["captures"]
        assert graph.replays == 5 - prog.WARMUP and pc.conv3x3_pair.launches == 3 * 4
    for ours, theirs in zip(out, host):
        _assert_same_predictions(ours, theirs)


@pytest.mark.parametrize("path", ["validate", "predict", "batched_fit"])
def test_a_failed_capture_raises(tmp_path, monkeypatch, path):
    """On the card's route a refused capture raises out of validate,
    predict and a batched fit's step; nothing goes back to the host's
    forwards or steps."""
    jcfg, tcfg, params, sd = _model_pair()
    val_ds = _dataset(ArrayDataset, 3, seed=1)
    with _card_schedule(monkeypatch, fail=True):
        tt = Trainer(tunet.UNet(tcfg, device="cpu"), POLICIES["none"],
                     TrainerConfig(verbose=False), device="cpu")
        with pytest.raises(RuntimeError, match="capturing"):
            if path == "validate":
                tt.validate(sd, val_ds)
            elif path == "predict":
                _predictions(tt.predict(sd, val_ds))
            else:
                _port_fit(tmp_path, tcfg, sd, True, "fit", max_epochs=3)


def test_a_failed_capture_takes_back_its_counts(monkeypatch):
    """launches.capture takes back the counts that the wrapper calls of a
    capture added when the capture fails too (it launched nothing), and
    turns the collector back on."""
    class _Graph:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: _Graph())
    monkeypatch.setattr(pc.conv3x3_pair, "launches", 4)

    def refused():
        pc.conv3x3_pair.launches += 3
        raise RuntimeError("operation not permitted when stream is capturing")

    enabled = gc.isenabled()
    with pytest.raises(RuntimeError, match="capturing"):
        launches.capture(refused)
    assert pc.conv3x3_pair.launches == 4 and gc.isenabled() == enabled


# (6) a dropped trainer ----------------------------------------------------------------

def test_a_dropped_trainer_frees_its_programs_at_once():
    """With the cyclic collector off, dropping a trainer frees its forward
    program (validate and predict made it) and its cached step program (a
    scanned epoch made it) at once: neither keeps the trainer alive."""
    jcfg, tcfg, params, sd = _model_pair()
    ds = _dataset(ArrayDataset, 3, seed=1)
    # the first torch.optim.SGD of a process imports torch's compiler stack,
    # which leaves the frames of that call (and a trainer in them) in
    # reference cycles; that one is built before the collector goes off
    torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        tt = Trainer(tunet.UNet(tcfg, device="cpu"), POLICIES["none"],
                     TrainerConfig(verbose=False), device="cpu")
        tt.validate(sd, ds)
        _predictions(tt.predict(None, ds))
        state = tt.create_state(None, 0.01)
        tt.train_epoch_scan(state, to_device((ds.images, ds.targets, ds.masks), tt.device),
                            np.arange(3), 0.01)
        refs = [weakref.ref(tt), weakref.ref(tt._forward), weakref.ref(tt._program)]
        del tt
        assert [r() for r in refs] == [None, None, None]
    finally:
        if enabled:
            gc.enable()


# (7) on the card ------------------------------------------------------------------------

def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
def test_replays_equal_eager_forwards_and_batched_steps_on_the_card(tmp_path):
    """On the card (pair convs, 64 filters so that K3 runs): validate and
    predict under none and lft, and predict_at at 32^2, through the
    forward programs (warm-up, capture, replays) against program=False,
    within 2e-3 of the outputs' largest magnitude, with equal launch
    counts; a batched fit (3 epochs at train_batch 2 over 5 images, lr
    1e-3) within the train-step-program bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    db = tunet.DropBlockConfig(kind="dependent", block_size=3, max_drop_prob=0.2, nr_steps=9,
                               mask_impl="kernel")
    cfg = tunet.canonical_config(dropblock=db, remat=True, filters=64, model_depth=2,
                                 group_norm_groups=32, conv_impl="pair")
    start = tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    val_ds = _dataset(ArrayDataset, 3, 64, 64, seed=1)
    out = {}
    for program in (True, False):
        model = tunet.UNet(cfg, device=dev)
        model.load_state_dict(start)
        before = launches.snapshot()
        got = []
        for policy in (POLICIES["none"], lf_policy("lft", 32)):
            tt = Trainer(model, policy, TrainerConfig(verbose=False), device=dev,
                         program=program)
            got.append(tt.validate(None, val_ds))
            got += [a for p in _predictions(tt.predict(None, val_ds)) for a in p[1:]]
        got += [a for p in _predictions(base_model_mf.predict_at(model, val_ds, 32, 32,
                                                                 program=program))
                for a in p[1:]]
        counts = launches.since(before)
        tt = Trainer(model, POLICIES["none"],
                     TrainerConfig(max_epochs=3, lr=1e-3, clip_norm=0.5, auto_lr_find=False,
                                   seed=5, verbose=False, train_batch=2, val_batch=2),
                     device=dev, program=program)
        _, hist, _ = tt.fit(_dataset(ArrayDataset, 5, 64, 64), val_ds,
                            str(tmp_path / f"fit_{program}"), params=start)
        params = torch.cat([p.detach().reshape(-1).float() for p in model.parameters()])
        out[program] = (got, counts, hist, params)
    (got_p, counts_p, hist_p, params_p), (got_h, counts_h, hist_h, params_h) = out.values()
    assert counts_p == counts_h and counts_p["conv3x3_pair"] > 0
    for a, b in zip(got_p, got_h):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 2e-3 * max(np.abs(b).max(), 1e-6)
    a = np.array(hist_p["train_loss_epoch"] + hist_p["val_loss_epoch"])
    b = np.array(hist_h["train_loss_epoch"] + hist_h["val_loss_epoch"])
    assert np.isfinite(a).all() and np.max(np.abs(a - b) / np.abs(b)) <= 2e-3
    assert _rel_l2(params_p, params_h) <= 1e-4
