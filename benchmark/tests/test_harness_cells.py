"""The harness finds every cell by the names in BENCHMARK.json, a cell added
as data files alone runs, the model's FLOP count and the kernels' bounds,
and the result line's keys."""

from __future__ import annotations

import io
import json
import re
import time
from pathlib import Path

import pytest

from benchmark import harness, readers, roofline, tracing
REPO = Path(__file__).resolve().parents[2]

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_workload_resolves_to_its_files(workload):
    spec = harness.load(REPO, workload)
    assert spec.config["name"] == spec.workload["config"]
    assert "setup_s" in spec.end_to_end and len(spec.end_to_end) >= 2
    assert spec.per_layer
    for name in list(spec.end_to_end) + list(spec.per_layer):
        assert callable(harness.reader(REPO, name))
    for name, metric in spec.per_layer.items():
        assert metric["moves"] in spec.end_to_end, name
    assert set(spec.traffic["limits"])


def test_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [e["name"] for e in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
             + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in layer for layer in layers)
    fours = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(SPEC["workloads"]) // 4)
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")


def test_cell_added_as_data_alone_runs(tiny_root):
    """A new traffic file and a BENCHMARK.json entry are all a cell needs."""
    traffic = json.loads((tiny_root / "benchmark/traffic/mc_drive_1000.json").read_text())
    traffic.update(members=12, chunk=4, drop_prob=0.3)
    (tiny_root / "benchmark/traffic/mc_drive_p30.json").write_text(json.dumps(traffic))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mc_drive_p30", "config": "unet31m_eval_bf16",
                              "traffic": "mc_drive_p30", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "mc_drive_1000" in m.get("workloads", []):
            m["workloads"].append("mc_drive_p30")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load(tiny_root, "mc_drive_p30")
    assert cell.traffic["drop_prob"] == 0.3
    line = harness.run(cell, 2**31 + 12345, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "ensemble_passes_per_s"}


def test_kind_added_as_a_file_is_found(tiny_root):
    """A traffic file may name a kind of its own: benchmark/kinds/<kind>.py."""
    (tiny_root / "benchmark/kinds/ensemble_twice.py").write_text(
        "from benchmark import cells\n\n\n"
        "class Cell(cells.kind('ensemble')):\n"
        "    def predict(self, i):\n"
        "        super().predict(i)\n"
        "        return super().predict(i)\n")
    traffic = json.loads((tiny_root / "benchmark/traffic/rot_drive_359.json").read_text())
    traffic["kind"] = "ensemble_twice"
    (tiny_root / "benchmark/traffic/rot_twice.json").write_text(json.dumps(traffic))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "rot_twice", "config": "unet31m_eval_bf16",
                              "traffic": "rot_twice", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "rot_drive_359" in m.get("workloads", []):
            m["workloads"].append("rot_twice")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load(tiny_root, "rot_twice")
    line = harness.run(cell, 2**31 + 777, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] and line["attempted"] >= 1


def test_result_line_has_the_contract_keys(tiny_root):
    spec = harness.load(tiny_root, "train_drive_b1")
    line = harness.run(spec, 7, 0.2, False, "cpu", time.perf_counter())
    out, err = io.StringIO(), io.StringIO()
    harness.report(line, out, err)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(last["device"])
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = err.getvalue().strip().splitlines()
    assert len(tail) == len(last["checks"]) and all(t.startswith("check ") for t in tail)


def test_model_flops_at_the_canvas():
    cfg = json.loads((REPO / "benchmark/configs/unet31m_eval_bf16.json").read_text())
    assert roofline.canvas(cfg, 584, 565) == (592, 576)
    assert roofline.forward_flops(cfg, 584, 565) == pytest.approx(500.456226816e9, rel=1e-12)


def test_kernel_bounds_of_a_chunk_and_a_step():
    cfg = json.loads((REPO / "benchmark/configs/unet31m_train_bf16.json").read_text())
    # the kernel table's bounds at (16, 592, 576, 64): K1 0.417 ms, K2 0.104, K3 0.417
    assert roofline.k1_bound(16, 592, 576, 64) == pytest.approx(0.417e-3, rel=2e-3)
    assert roofline.k2_bound(16, 592, 576, 64) == pytest.approx(0.104e-3, rel=5e-3)
    assert roofline.k3_bound(16, 592, 576, 64, 64) == pytest.approx(0.417e-3, rel=2e-3)
    assert roofline.k3_bound(16, 592, 576, 128, 64) == pytest.approx(0.813e-3, rel=2e-3)
    assert len(roofline.mask_sites(cfg, 592, 576)) == 22
    assert roofline.k3_sites(cfg, 592, 576) == [(592, 576, 64, 64), (592, 576, 128, 64),
                                                (592, 576, 64, 64)]
    step = roofline.expected(cfg, {"steps": 1, "rows": 1, "h": 584, "w": 565})
    assert step["k2"][0] == 40 and step["k3"][0] == 12  # 22 + 18 remat; 6 + 3 dx + 3 folds
    chunk = roofline.expected(dict(cfg, remat=False),
                              {"forwards": [16], "h": 584, "w": 565, "dropblock": True})
    assert chunk["k1"][0] == 22 and chunk["k3"][0] == 3


class _Cell:
    chips, mesh, on_card = 1, None, True


def _run(ops, credited=None, wall=1.0, expected=None, unit="image"):
    trace = tracing.Trace(wall, ops, [("predict", 0.0, 2e6)], credited or {})
    window = type("W", (), {"unit": unit, "seconds": [1.0], "work": 16, "wall_s": 1.0})()
    return harness.Run(_Cell(), 1.0, window, 0, trace, [(trace.busy_s, wall)], {}, expected)


def test_trace_arithmetic():
    ops = [("conv3x3_wgmma_kernel", 0.0, 100.0), ("conv3x3_wgmma_kernel", 50.0, 150.0),
           ("elementwise_kernel", 400.0, 500.0), ("ncclDevKernel_AllReduce", 900.0, 1000.0)]
    run = _run(ops, {"path:wgmma": 2}, wall=1e-3, expected={"k3": (2, 100e-6)})
    assert run.trace.busy_s == pytest.approx(350e-6)
    assert readers.idle_share(run, "image") == pytest.approx(65.0)
    assert readers.roofline_share(run, "k3", "image") == pytest.approx(50.0)
    assert not run.trace.lost()
    gaps = run.trace.breakdown()["idle_gaps"]
    assert gaps[0] == ["predict", pytest.approx(400e-6)]
    # a lost record: the recorded time stands for every credited launch
    lossy = _run(ops[1:], {"path:wgmma": 2}, wall=1e-3, expected={"k3": (2, 100e-6)})
    assert lossy.trace.lost() == {"path:wgmma": (2, 1)}
    assert readers.roofline_share(lossy, "k3", "image") == pytest.approx(50.0)
    assert readers.roofline_share(run, "k1", "image") is None
