"""The port's spans (spans.py) and its host-side counts (ops/cuda/launches.py):
with no profiler recording no span enters the profiler; under a CPU
torch.profiler the engines' and the trainer's spans appear with their
nesting, one per step and per host chunk, and none from inside a function
that a CUDA graph captures; the members merged from the host and in the
ensemble programs add up to the ensemble; the host-side counts pass through
since(), credit() and a capture's take-back. The card's schedule (warm-up,
capture, replays) runs with stand-ins for the CUDA graph and streams."""

import contextlib
import functools

import numpy as np
import pytest
import torch

from unet_research_tpu_torch import spans
from unet_research_tpu_torch.data import ArrayDataset
from unet_research_tpu_torch.data.loading import to_device
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.cuda import shear_rotate as sr
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig
from unet_research_tpu_torch.train import loop as tloop
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine, RotationalEngine
from unet_research_tpu_torch.uncertainty import ensemble
from unet_research_tpu_torch.uncertainty.ensemble import chunk_layout

SMALL = dict(filters=4, model_depth=2, group_norm_groups=2)
MEMBERS, CHUNK = 11, 3  # a head chunk, two body chunks, a tail of 2
STEPS = 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(h=20, w=18):
    rng = np.random.default_rng(0)
    im = rng.random((1, h, w, 1)).astype(np.float32)
    gt = (rng.random((1, h, w, 1)) > 0.5).astype(np.float32)
    mask = np.ones((1, h, w, 1), np.float32)
    return im, gt, mask


def _engine(kind: str, program: bool = True, return_num: int = 0):
    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu",
                       generator=torch.Generator().manual_seed(1)).eval()
    common = dict(num_iterations=MEMBERS, return_num=return_num, chunk=CHUNK, device="cpu",
                  program=program)
    if kind == "mc":
        return MCDropBlockEngine(model, **common)
    return RotationalEngine(model, warp="gather", **common)


def _predict(engine):
    if isinstance(engine, MCDropBlockEngine):
        return engine.predict(*_image(), 0.2, generator=torch.Generator().manual_seed(3))
    return engine.predict(*_image())


def _trainer_and_data():
    db = tunet.DropBlockConfig(kind="dependent", block_size=3, use_scheduler=True,
                               start_drop_prob=0.0, max_drop_prob=0.2, nr_steps=3,
                               mask_impl="kernel")
    model = tunet.UNet(tunet.canonical_config(dropblock=db, **SMALL), device="cpu",
                       generator=torch.Generator().manual_seed(1))
    trainer = Trainer(model, POLICIES["none"], TrainerConfig(seed=2, verbose=False),
                      device="cpu")
    rng = np.random.default_rng(0)
    ds = ArrayDataset((rng.random((STEPS, 16, 16, 1)) * 255).astype(np.uint8),
                      ((rng.random((STEPS, 16, 16, 1)) > 0.7) * 255).astype(np.uint8),
                      np.full((STEPS, 16, 16, 1), 255, np.uint8))
    data = to_device((ds.images, ds.targets, ds.masks), torch.device("cpu"))
    return trainer, trainer.create_state(None, 1e-3), data


def _run(case: str):
    """One MC predict, one rotational predict, one scanned or one stepped
    epoch of STEPS steps."""
    if case in ("mc", "rot"):
        return _predict(_engine(case))
    trainer, state, data = _trainer_and_data()
    order = np.random.default_rng(1).permutation(STEPS)
    if case == "scan":
        return trainer.train_epoch_scan(state, data, order, 1e-3)
    return trainer._step_epoch(state, data, order, None, 1e-3, None, True,
                               np.random.default_rng(1), 0)


def _profiled(fn) -> list:
    """fn() under a CPU profiler; the events it recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return list(prof.events())


def _ancestors(ev, prefix: str) -> list:
    """The names of ev's enclosing events that start with `prefix`,
    innermost first."""
    out, p = [], ev.cpu_parent
    while p is not None:
        if p.name.startswith(prefix):
            out.append(p.name)
        p = p.cpu_parent
    return out


def _spans(events) -> list:
    """(span, its parent span or None) of every unet. span, in order."""
    out = []
    for ev in sorted(events, key=lambda e: e.time_range.start):
        if ev.name.startswith("unet."):
            up = _ancestors(ev, "unet.")
            out.append((ev.name[5:], up[0][5:] if up else None))
    return out


CASES = ["mc", "rot", "scan", "stepped"]


@pytest.mark.parametrize("case", CASES)
def test_spans_off_enter_no_profiler(monkeypatch, case):
    """With no profiler recording, span() hands out the one shared no-op
    context and never enters record_function."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("engine.predict") is spans.span("trainer.step")
    _run(case)


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_under_their_root(case):
    """Under a CPU profiler each span appears under the parent the module
    docstring gives it: the host chunks (head and tail) and the body inside
    the predict, one trainer.step per step inside the epoch."""
    got = _spans(_profiled(lambda: _run(case)))
    names = [n for n, _ in got]
    if case in ("mc", "rot"):
        root = "engine.predict"
        layout = chunk_layout(MEMBERS, CHUNK)
        hosts = len(layout.sizes) - layout.n_body
        want = ["engine.input"] + (["engine.keys"] if case == "mc" else []) + [
            "engine.fill", "engine.host_chunk", "engine.body"] + [
            "engine.host_chunk"] * (hosts - 1) + ["engine.finish"]
    else:
        root = "trainer.epoch"
        want = ["trainer.fill"] + ["trainer.step"] * STEPS + ["trainer.losses"]
    assert names == [root] + want
    assert got[0] == (root, None) and all(parent == root for _, parent in got[1:])


def test_lr_find_validate_and_checkpoint_spans_in_fit(tmp_path, monkeypatch):
    """A fit with lr_find (a 12-step sweep) under a profiler: the sweep's
    fill and steps sit inside trainer.lr_find, validation and the
    checkpoint have their spans."""
    trainer, _, _ = _trainer_and_data()
    trainer.cfg = TrainerConfig(max_epochs=1, seed=2, verbose=False, auto_lr_find=True)
    rng = np.random.default_rng(0)
    ds = ArrayDataset((rng.random((3, 16, 16, 1)) * 255).astype(np.uint8),
                      ((rng.random((3, 16, 16, 1)) > 0.7) * 255).astype(np.uint8),
                      np.full((3, 16, 16, 1), 255, np.uint8))
    monkeypatch.setattr(tloop, "lr_find", functools.partial(tloop.lr_find, num_training=12))
    got = _spans(_profiled(lambda: trainer.fit(ds, ds, str(tmp_path / "mi"))))
    sweep = [n for n, p in got if p == "trainer.lr_find"]
    assert sweep[0] == "trainer.fill" and len(sweep) >= 3
    assert set(sweep[1:]) == {"trainer.step"}
    roots = [n for n, p in got if p is None]
    assert roots == ["trainer.lr_find", "trainer.epoch", "trainer.validate",
                     "trainer.checkpoint"]


@pytest.mark.parametrize("case", CASES)
def test_no_span_inside_a_captured_function(monkeypatch, case):
    """The functions a CUDA graph captures (a step program's step, an
    ensemble program's step, the members' forward inside them) record no
    span: a span there would record at the capture only."""
    for cls in (tloop._StepProgram, ensemble.EnsembleProgram):
        inner = cls.step

        def step(self, *args, _inner=inner, **kwargs):
            with torch.profiler.record_function("captured.step"):
                return _inner(self, *args, **kwargs)

        monkeypatch.setattr(cls, "step", step)
    events = _profiled(lambda: _run(case))
    steps = [ev for ev in events if ev.name == "captured.step"]
    assert steps and all(_ancestors(ev, "captured.") == [] for ev in events
                         if ev.name.startswith("unet."))


@pytest.mark.parametrize("kind", ["mc", "rot"])
@pytest.mark.parametrize("program", [True, False])
@pytest.mark.parametrize("return_num", [0, 4])
def test_members_add_up_to_the_ensemble(kind, program, return_num):
    """members:host + members:program is the ensemble's size, and the host's
    share is the layout's head and tail (all of it with program=False)."""
    layout = chunk_layout(MEMBERS, CHUNK, return_num)
    body = layout.n_body * CHUNK
    before = launches.snapshot()
    _predict(_engine(kind, program, return_num))
    got = launches.since(before)
    want = ({"members:host": MEMBERS - body, "members:program": body} if program
            else {"members:host": MEMBERS})
    assert {k: v for k, v in got.items() if k.startswith("members:")} == want
    assert "graph:captures" not in got  # nothing is captured on the CPU


class _FakeGraph:
    def replay(self):
        pass


class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


def _stand_ins(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda side: contextlib.nullcontext())


def test_host_counts_pass_since_credit_and_the_capture(monkeypatch):
    """A capture adds one to graph:captures and keeps it (its take-back
    takes back the launches only, which are the replay's counts); credit
    takes the host-side names and the wrappers', and a negative credit
    takes them back."""
    _stand_ins(monkeypatch)
    before = launches.snapshot()
    assert {"graph:captures", "members:host", "members:program"} <= set(before)

    def step():
        sr.rotate_fan_table.launches += 2
        launches.HOST["members:program"] += 5  # host-side, not a replay's

    graph, counts, _ = launches.capture(step)
    assert counts == {"rotate_fan_table": 2}
    assert launches.since(before) == {"graph:captures": 1, "members:program": 5}
    host = {"graph:captures": 2, "members:host": 3, "path:wgmma": 1, "rotate_fan_table": 1}
    launches.credit(host, 2)
    assert launches.since(before) == {"graph:captures": 5, "members:host": 6,
                                      "members:program": 5, "path:wgmma": 2,
                                      "rotate_fan_table": 2}
    assert launches.launched(launches.since(before)) == {"path:wgmma": 2,
                                                         "rotate_fan_table": 2}
    launches.credit(host, -2)
    launches.credit({"graph:captures": 1, "members:program": 5}, -1)
    assert launches.since(before) == {}


def test_warmup_and_capture_spans_on_the_card_schedule(monkeypatch):
    """KeyedGraphs on the card's schedule with stand-ins: its eager warm-up
    inside graph.warmup, the capture inside graph.capture (counted once),
    the replays outside both and credited without graph:captures."""
    _stand_ins(monkeypatch)

    class Graphs(launches.KeyedGraphs):
        WARMUP = 1

    graphs = Graphs()

    def fn():
        sr.rotate_fan_table.launches += 1

    before = launches.snapshot()
    events = _profiled(lambda: [graphs.run("k", fn, torch.device("cuda")) for _ in range(4)])
    assert [n for n, _ in _spans(events)] == ["graph.warmup", "graph.capture"]
    assert launches.since(before) == {"graph:captures": 1, "rotate_fan_table": 4}
    launches.credit(launches.since(before), -1)
