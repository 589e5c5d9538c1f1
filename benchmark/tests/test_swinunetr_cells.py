"""The cell `rot_swinunetr_359`: it runs whole on the CPU at a tiny size
(conftest.py's cut, with Swin UNETR's widths cut alike), comes out correct,
fails with the float8 control and with the timed path broken underneath,
and reads its new metrics; its bounds count the window attention calls. The
readers of the three `*.swinunetr` metrics on synthetic profiled windows."""

from __future__ import annotations

import contextlib
import json
import time
import types
from pathlib import Path

import pytest

from benchmark import cells, harness
from benchmark.reference import swinunetr
from benchmark.tracing import Trace

REPO = Path(__file__).resolve().parents[2]
TINY = dict(feature_size=16, heads=[1, 2, 4, 8], filters=16)
NEW = ("mfu.swinunetr", "wattn_roofline.swinunetr", "wattn_efficient_share.swinunetr")


@pytest.fixture
def swin_root(tiny_root):
    path = tiny_root / "benchmark/configs/swinunetr_f48_eval_bf16.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    cfg["dropblock"]["block_size"] = 3
    path.write_text(json.dumps(cfg))
    path = tiny_root / "benchmark/traffic/rot_swinunetr_359.json"
    t = json.loads(path.read_text())
    t.update(height=60, width=50, frames=2, members=12, chunk=8, reference_rows=8)
    path.write_text(json.dumps(t))
    return tiny_root


def test_rot_swinunetr_runs_correct(swin_root):
    spec = harness.load(swin_root, "rot_swinunetr_359")
    line = harness.run(spec, 2**31 + 99, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] and line["attempted"] >= 1, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "ensemble_passes_per_s"}
    # float32 on both sides at a tiny size: the gaps are rounding
    assert all(c["value"] < 1e-4 for c in line["checks"].values()), line["checks"]


def test_swinunetr_kind_refuses_mc_traffic(swin_root):
    """The kind runs the rotational engine alone: MC traffic is refused at
    set-up, before any weight is drawn."""
    spec = harness.load(swin_root, "rot_swinunetr_359")
    traffic = dict(spec.traffic, engine="mc", drop_prob=0.15)
    cell = cells.make_cell(spec.workload, spec.config, traffic, 5, "cpu", None, swin_root)
    with pytest.raises(ValueError, match="rotational"):
        cell.setup()
    assert not hasattr(cell, "weights")


def test_rot_swinunetr_readers(swin_root):
    """Off the card the trace readers find nothing; mfu.swinunetr reads the
    window; the bound counts one call a Swin block and forward."""
    spec = harness.load(swin_root, "rot_swinunetr_359")
    assert set(NEW) <= set(spec.per_layer)
    assert not {"mfu.ensemble", "k1_roofline.ensemble", "attn_roofline.transunet",
                "mfu.transunet"} & set(spec.per_layer)
    cell = cells.make_cell(spec.workload, spec.config, spec.traffic, 5, "cpu", None, swin_root)
    cell.setup()
    window = cell.window(0.1)
    run = harness.Run(cell, 1.0, window, 0)
    assert 0 < harness.reader(swin_root, "mfu.swinunetr")(run) < 100
    for name in NEW[1:]:
        assert harness.reader(swin_root, name)(run) is None
    calls, seconds = cell.window_attention_bound([8, 4])
    assert calls == 2 * sum(spec.config["depths"]) and seconds > 0


def test_control_fails_the_limits(swin_root):
    spec = harness.load(swin_root, "rot_swinunetr_359")
    cell = cells.make_cell(spec.workload, spec.config, spec.traffic, 5, "cpu", root=swin_root)
    cell.inputs()
    gaps = cell.control()
    limits = spec.traffic["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps


def _half_of_each_chunk():
    from unet_research_tpu_torch.uncertainty import ensemble

    whole = ensemble._batch_stats
    stack = contextlib.ExitStack()
    ensemble._batch_stats = lambda outs: whole(outs[:max(1, outs.shape[0] // 2)])
    stack.callback(setattr, ensemble, "_batch_stats", whole)
    return stack


def _altered_mean():
    from unet_research_tpu_torch.uncertainty import rotational

    stats = rotational.ensemble_stats

    def altered(*a, **k):
        mean, std, saved = stats(*a, **k)
        return mean * 1.02, std, saved

    stack = contextlib.ExitStack()
    rotational.ensemble_stats = altered
    stack.callback(setattr, rotational, "ensemble_stats", stats)
    return stack


@pytest.mark.parametrize("fault", [_half_of_each_chunk, _altered_mean],
                         ids=["half_of_each_chunk", "altered_mean"])
def test_fault_is_not_correct(swin_root, fault):
    spec = harness.load(swin_root, "rot_swinunetr_359")
    with fault():
        line = harness.run(spec, 2**31 + 4242, 0.2, False, "cpu", time.perf_counter())
    assert not line["correct"], line["checks"]


def test_window_attention_bound_at_the_cell():
    """The cell's bound at DRIVE's canvas: 8 calls a forward; a call of 16
    members at stage 0 reads and writes 4 x 16 x 1848 x 49 x 48 bf16 values
    (bytes bind), and 3 x 1848 x 49 x 49 x 2 bytes of mask in its shifted
    block."""
    spec = harness.load(REPO, "rot_swinunetr_359")
    kind = cells.kind("swinunetr_ensemble")
    cell = kind(spec.workload, spec.config, spec.traffic, 1, "cpu")
    calls, seconds = cell.window_attention_bound([16])
    assert calls == 8
    stage0 = 4 * 16 * 1848 * 49 * 48 * 2
    assert seconds > 2 * stage0 / 3.35e12
    assert seconds < 2.2 * stage0 / 3.35e12 * 2  # the later stages move half as much each
    assert cell.member_flops() == swinunetr.model_flops(spec.config, 608, 576)


# --- the readers on synthetic windows ------------------------------------------------

def _run(credited=None, ops=None, unit="image", traced=True, cell=None):
    trace = Trace(1e-3, ops or [("k", 0, 10)], [], dict(credited or {})) if traced else None
    return types.SimpleNamespace(trace=trace, window=types.SimpleNamespace(unit=unit),
                                 work={"forwards": [16, 16]}, cell=cell)


@pytest.mark.parametrize("efficient,other,share", [(16, 0, 100.0), (12, 4, 75.0), (0, 8, 0.0)])
def test_efficient_share_read(efficient, other, share):
    read = harness.reader(REPO, "wattn_efficient_share.swinunetr")
    credited = {"attn:efficient": efficient, "attn:other": other, "attn:flash": 0}
    assert read(_run(credited)) == pytest.approx(share)


def test_efficient_share_reads_none_without_the_program():
    read = harness.reader(REPO, "wattn_efficient_share.swinunetr")
    calls = {"attn:efficient": 16, "attn:flash": 0, "attn:other": 0}
    assert read(_run(dict(calls, **{"attn:efficient": 0}))) is None  # no call
    # a program without the count (the parent's attention counts)
    assert read(_run({"attn:flash": 12, "attn:other": 0, "gn_apply": 60})) is None
    assert read(_run(calls, traced=False)) is None
    assert read(_run(calls, unit="epoch")) is None


def test_roofline_read_scales_lost_records():
    """The bound over the recorded kernels' time, that time standing for every
    call where the profiler lost some records."""
    read = harness.reader(REPO, "wattn_roofline.swinunetr")
    cell = types.SimpleNamespace(window_attention_bound=lambda forwards: (16, 0.002))
    ops = [(f"fmha_cutlassF_bf16_aligned_64x64_rf_sm80(x{i})", 0, 500) for i in range(16)]
    assert read(_run(ops=ops, cell=cell)) == pytest.approx(25.0)  # 2 ms of 8 ms
    assert read(_run(ops=ops[:8], cell=cell)) == pytest.approx(25.0)  # half lost
    assert read(_run(ops=[("flash_fwd_kernel", 0, 500)], cell=cell)) is None
    assert read(_run(ops=ops, cell=types.SimpleNamespace())) is None  # another cell
    assert read(_run(ops=ops, cell=cell, traced=False)) is None


def test_entries_name_the_swin_cell():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in NEW:
        (entry,) = [m for m in spec["per_layer"] if m["name"] == name]
        assert entry["workloads"] == ["rot_swinunetr_359"]
        assert entry["moves"] == "ensemble_passes_per_s" and entry["unit"] == "%"
    (config,) = [c for c in spec["configs"] if c["name"] == "swinunetr_f48_eval_bf16"]
    assert config["reduced"] == []
