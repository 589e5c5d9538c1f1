"""A run with the timed path broken underneath comes out not correct, once for
each fault that a cell can have: half of a batch left out (the mean taken
over the rest), an answer altered where it is produced, a train step that
returns its state unchanged, a learning rate or a momentum off, and the
exchange between the ranks left out.
The runs skip the harness's look for a card and run on the CPU at a tiny
size (conftest.py), under the cells' own limits."""

from __future__ import annotations

import contextlib
import json
import socket
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from benchmark import harness


def _patch(module, name, value):
    stack = contextlib.ExitStack()
    old = getattr(module, name)
    setattr(module, name, value)
    stack.callback(setattr, module, name, old)
    return stack


def half_of_each_chunk():
    """Each chunk's statistics over its first half of members only."""
    from unet_research_tpu_torch.uncertainty import ensemble

    whole = ensemble._batch_stats
    return _patch(ensemble, "_batch_stats", lambda outs: whole(outs[:max(1, outs.shape[0] // 2)]))


def altered_mean():
    """The engines' mean scaled by 1.02 where the statistics are produced."""
    from unet_research_tpu_torch.uncertainty import mc_dropblock, rotational

    stack = contextlib.ExitStack()
    for module in (mc_dropblock, rotational):
        stats = module.ensemble_stats

        def altered(*a, _stats=stats, **k):
            mean, std, saved = _stats(*a, **k)
            return mean * 1.02, std, saved

        stack.enter_context(_patch(module, "ensemble_stats", altered))
    return stack


def unchanged_state():
    """apply_gradients zeroes the gradients and counts the step, and updates
    nothing."""
    from unet_research_tpu_torch.train.state import TrainState

    def apply(self, lr=None):
        for p in self.params:
            p.grad.zero_()
        self.step += 1

    return _patch(TrainState, "apply_gradients", apply)


def lr_5pc_high():
    """Every step of the step program at 1.05 times the learning rate."""
    from unet_research_tpu_torch.train import loop

    fill = loop._StepProgram.fill

    def high(self, order, lr, rows=None):
        fill(self, order, np.asarray(lr, np.float32) * np.float32(1.05), rows)

    return _patch(loop._StepProgram, "fill", high)


def momentum_0_9():
    """SGD's momentum 0.9 in place of the configuration's 0.99."""
    from unet_research_tpu_torch.train.state import TrainState

    init = TrainState.__init__

    def wrong(self, *a, **k):
        init(self, *a, **k)
        self.optimizer.param_groups[0]["momentum"] = 0.9

    return _patch(TrainState, "__init__", wrong)


def half_of_the_batch():
    """The upper half of the ranks' rows left out of the loss and its
    normaliser: the mean over the rest."""
    from unet_research_tpu_torch.train import loop

    whole = loop.masked_rescaled_bce

    def half(seg, gt, mask, mesh=None):
        keep = 0.0 if mesh is not None and mesh.rank >= mesh.size // 2 else 1.0
        return whole(seg * keep, gt * keep, mask * keep, mesh=mesh)

    return _patch(loop, "masked_rescaled_bce", half)


def no_exchange():
    """Each rank steps on its own share of the gradient."""
    from unet_research_tpu_torch.train import state

    return _patch(state, "all_reduce_grads_", lambda grads, mesh: None)


def sound():
    return contextlib.ExitStack()


FAULTS = {f.__name__: f for f in (sound, half_of_each_chunk, altered_mean, unchanged_state,
                                  lr_5pc_high, momentum_0_9, half_of_the_batch, no_exchange)}


def run_once(root: Path, workload: str, fault: str) -> dict:
    spec = harness.load(root, workload)
    with FAULTS[fault]():
        return harness.run(spec, 2**31 + 4242, 0.2, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload,fault", [
    ("mc_drive_1000", "sound"), ("mc_drive_1000", "half_of_each_chunk"),
    ("mc_drive_1000", "altered_mean"), ("rot_drive_359", "sound"),
    ("rot_drive_359", "half_of_each_chunk"), ("rot_drive_359", "altered_mean"),
    ("train_drive_b1", "sound"), ("train_drive_b1", "unchanged_state"),
    ("train_drive_b1", "lr_5pc_high"), ("train_drive_b1", "momentum_0_9")])
def test_fault_is_not_correct(tiny_root, workload, fault):
    line = run_once(tiny_root, workload, fault)
    assert line["correct"] == (fault == "sound"), line["checks"]


def _rank(rank: int, world: int, port: int, root: str, fault: str, out: str) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    spec = harness.load(Path(root), "train_dp4_b4")
    mesh = harness.join(f"tcp://127.0.0.1:{port}", rank, world, torch.device("cpu"))
    with FAULTS[fault]():
        line = harness.run(spec, 2**31 + 4243, 0.2, False, "cpu", time.perf_counter(), mesh)
    if rank == 0:
        Path(out).write_text(json.dumps(line))


def run_mesh(root: Path, fault: str, tmp: Path) -> dict:
    """train_dp4_b4 over four gloo ranks on the CPU."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp / f"{fault}.json"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, 4, port, str(root), fault, str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        assert not p.is_alive() and p.exitcode == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("fault", ["sound", "unchanged_state", "half_of_the_batch",
                                   "no_exchange", "momentum_0_9"])
def test_mesh_fault_is_not_correct(tiny_root, tmp_path, fault):
    line = run_mesh(tiny_root, fault, tmp_path)
    assert line["correct"] == (fault == "sound"), line["checks"]
