"""The reader of `merge_kernel_share.ensemble`
(metrics/merge_kernel_share.ensemble.py) on synthetic profiled windows: the
share of the U-Net's skip merges on the fused route that took K1's merge
mode, from the program's credited counts `merge:kernel` and `merge:plain`;
None where the window made no such merge, where the program has no such
count (a program older than it), without a trace and on another kind of
window. Its BENCHMARK.json entry names the cell that reads it."""

from __future__ import annotations

import json
import types
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tracing import Trace

REPO = Path(__file__).resolve().parents[2]
NAME = "merge_kernel_share.ensemble"


def _run(credited, unit="image", traced=True):
    trace = Trace(1e-3, [("k", 0, 10)], [], dict(credited)) if traced else None
    return types.SimpleNamespace(trace=trace, window=types.SimpleNamespace(unit=unit))


@pytest.mark.parametrize("kernel,plain,share", [(252, 0, 100.0), (189, 63, 75.0),
                                                (0, 252, 0.0)])
def test_counts_given_share_read(kernel, plain, share):
    read = harness.reader(REPO, NAME)
    credited = {"merge:kernel": kernel, "merge:plain": plain, "dropblock_fused_apply": 1386}
    assert read(_run(credited)) == pytest.approx(share)


def test_no_merge_or_no_count_reads_none():
    read = harness.reader(REPO, NAME)
    assert read(_run({"merge:kernel": 0, "merge:plain": 0})) is None  # DropBlock off, TransUNet
    assert read(_run({"up:kernel": 252, "dropblock_fused_apply": 1386})) is None  # the parent
    assert read(_run({"merge:kernel": 252, "merge:plain": 0}, traced=False)) is None
    assert read(_run({"merge:kernel": 252, "merge:plain": 0}, unit="epoch")) is None


def test_entry_names_the_mc_cell():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (entry,) = [m for m in spec["per_layer"] if m["name"] == NAME]
    assert entry["workloads"] == ["mc_drive_1000"]
    assert entry["moves"] == "ensemble_passes_per_s" and entry["unit"] == "%"
    assert entry["layer"] == "mask sites" and entry["source"] == "program_counter"
    cells = {w["name"] for w in spec["workloads"]}
    assert set(entry["workloads"]) <= cells
