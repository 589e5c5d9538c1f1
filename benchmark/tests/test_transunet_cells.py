"""The cells `mc_transunet_1000` and `train_mf_uni` run whole on the CPU at a
tiny size (conftest.py's cut, with TransUNet's widths cut alike and its
frames large enough for its 16x reduction), come out correct, and read
their new metrics; TransUNet's bounds count its calls and sites."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import cells, harness
from benchmark.reference import transunet

TINY = dict(width=8, units=[1, 1, 1], hidden=16, layers=2, heads=2, mlp=32, head_channels=16,
            decoder=[16, 8, 8, 4], grid=[4, 4], gn_groups=4, filters=8)


@pytest.fixture
def transunet_root(tiny_root):
    path = tiny_root / "benchmark/configs/transunet_r50b16_eval_bf16.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    cfg["dropblock"]["block_size"] = 3
    path.write_text(json.dumps(cfg))
    path = tiny_root / "benchmark/traffic/mc_transunet_1000.json"
    t = json.loads(path.read_text())
    t.update(height=60, width=64, frames=2, members=20, chunk=8, reference_rows=8)
    path.write_text(json.dumps(t))
    return tiny_root


def test_mc_transunet_runs_correct(transunet_root):
    spec = harness.load(transunet_root, "mc_transunet_1000")
    line = harness.run(spec, 2**31 + 99, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] and line["attempted"] >= 1, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "ensemble_passes_per_s"}


def test_mc_transunet_readers(transunet_root):
    """Off the card the trace readers find nothing; mfu.transunet reads the
    window."""
    spec = harness.load(transunet_root, "mc_transunet_1000")
    assert {"mfu.transunet", "attn_roofline.transunet", "k1_roofline.transunet",
            "attn_flash_share.transunet"} <= set(spec.per_layer)
    cell = cells.make_cell(spec.workload, spec.config, spec.traffic, 5, "cpu", None,
                           transunet_root)
    cell.setup()
    window = cell.window(0.1)
    run = harness.Run(cell, 1.0, window, 0)
    assert 0 < harness.reader(transunet_root, "mfu.transunet")(run) < 100
    for name in ("attn_roofline.transunet", "k1_roofline.transunet",
                 "attn_flash_share.transunet"):
        assert harness.reader(transunet_root, name)(run) is None
    calls, seconds = cell.attention_bound([16, 8])
    assert calls == 2 * 2 and seconds > 0
    launches, _ = cell.k1_bound([16])
    assert launches == transunet.num_sites(spec.config) == 2 + 2 * 3 + 8 + 3


def test_train_mf_uni_runs_correct(tiny_root):
    spec = harness.load(tiny_root, "train_mf_uni")
    line = harness.run(spec, 2**31 + 4321, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] and line["attempted"] >= 1, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "train_images_per_s"}


def test_train_plan_checks_every_size(tiny_root):
    """Set-up's epoch runs one step of each of the plan's sizes, in the order
    they first come in it, three times; the window's epochs run the drawn
    plan, make_size_plan's uni plan: a third each at 128, 256 and native."""
    spec = harness.load(tiny_root, "train_mf_uni")
    traffic = dict(spec.traffic, frames=504)
    cell = cells.make_cell(spec.workload, spec.config, traffic, 11, "cpu", None, tiny_root)
    cell.inputs()
    plan = list(cell.plan)
    assert len(plan) == 504 and sorted(set(plan)) == [-1, 128, 256]
    assert plan.count(128) == plan.count(256) == 5 * 36 and plan.count(-1) == 4 * 36
    assert cell.check_steps == 3 and cell.sizes == sorted(set(plan), key=plan.index)
    assert list(cell.set_up_plan[:9]) == cell.sizes * 3 and list(cell.set_up_plan[9:]) == plan
