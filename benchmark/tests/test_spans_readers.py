"""The readers of the program's spans and counts (benchmark/spans.py and its
seven metric files) on synthetic profiled windows: which gaps are
host-bound and to which span they are put down, the lead-in, the share
against the window's idle share, and None where the program has no span or
count (a program older than them)."""

from __future__ import annotations

import json
import statistics
import types
from pathlib import Path

import pytest

from benchmark import harness, readers, spans
from benchmark.tracing import Trace

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NEW = ("host_idle_share.ensemble", "host_member_share.ensemble", "graph_captures.ensemble",
       "host_idle_share.train", "fill_ms.train", "step_issue_ms.train", "graph_captures.train")

# one epoch's slice, in microseconds: the root span opens at 0; the fill
# draws on the host until its first copy at 40; two steps issue graph
# launches; a gap with no launch inside (200-205) is device-side
HOST = [("unet.trainer.epoch", 0, 296), ("unet.trainer.fill", 2, 60),
        ("cudaMemcpyAsync", 38, 39), ("cudaMemcpyAsync", 52, 54),
        ("unet.trainer.step", 70, 80), ("cudaGraphLaunch", 72, 78),
        ("unet.trainer.step", 90, 96), ("cudaGraphLaunch", 91, 95),
        ("aten::copy_", 300, 310), ("cudaLaunchKernel", 301, 303)]
OPS = [("Memcpy HtoD", 40, 50), ("Memcpy HtoD", 55, 58),  # gap 50-55: the second copy
       ("k_a", 79, 200), ("k_b", 205, 290),  # gap 58-79: the first launch; 200-205 none
       ("k_c", 304, 320)]  # gap 290-304: a launch outside any span of the program
COUNTS = {"graph:captures": 0, "members:host": 24, "members:program": 976}


def _trace(host=HOST, ops=OPS, credited=COUNTS, wall_s=400e-6):
    return Trace(wall_s, list(ops), list(host), dict(credited))


def _run(trace, unit="epoch"):
    busy = trace.busy_s if trace is not None else 0.0
    return types.SimpleNamespace(trace=trace, window=types.SimpleNamespace(unit=unit),
                                 ranks=[(busy, trace.wall_s if trace else 1.0)])


def test_gaps_put_down_to_the_innermost_span():
    """Lead-in 0-40 and the fill's copy gap 50-55 to trainer.fill, the
    launch gap 58-79 to trainer.step, 290-304 outside the program, 200-205
    device-side."""
    got = spans.host_idle(_trace())
    want = {"trainer.fill": 45e-6, "trainer.step": 21e-6, spans.OUTSIDE: 14e-6}
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v) for k, v in want.items())


def test_a_gap_without_a_launch_inside_is_device_side():
    """Without launch records every gap is device-side; the lead-in still
    counts, put down to the span open when the first operation starts."""
    host = [h for h in HOST if not h[0].startswith(("cuda", "aten"))]
    got = spans.host_idle(_trace(host=host))
    assert got == {"trainer.fill": pytest.approx(40e-6)}


def test_a_launch_that_ends_after_its_operation_started_counts():
    """The card was idle when the launch began and its kernel started before
    the call returned: the gap is host-bound still."""
    host = [("unet.engine.predict", 0, 100), ("unet.engine.host_chunk", 5, 90),
            ("cudaLaunchKernel", 30, 45)]
    ops = [("k_a", 10, 20), ("k_b", 40, 60)]
    assert spans.host_idle(_trace(host=host, ops=ops)) == {
        "engine.host_chunk": pytest.approx(30e-6)}  # the lead-in 0-10 and the gap 20-40


def test_no_lead_in_when_the_card_starts_first():
    host = [("unet.engine.predict", 50, 100)]
    ops = [("k_a", 10, 60), ("k_b", 70, 80)]
    assert spans.host_idle(_trace(host=host, ops=ops)) == {}


@pytest.mark.parametrize("unit", ["epoch", "image"])
def test_host_idle_share_is_within_the_idle_share(unit):
    run = _run(_trace(), unit)
    share, idle = spans.host_idle_share(run, unit), readers.idle_share(run, unit)
    assert share == pytest.approx(100 * 80 / 400) and 0 <= share <= idle


def test_span_and_count_readers():
    run = _run(_trace())
    assert spans.span_ms(run, "epoch", "trainer.fill") == pytest.approx(0.058)
    assert spans.span_ms(run, "epoch", "trainer.step", statistics.median) == pytest.approx(0.008)
    assert spans.counted(run, "epoch", "graph:captures") == 0
    assert spans.member_share(_run(_trace(), "image"), "image") == pytest.approx(2.4)
    assert spans.span_ms(run, "image", "trainer.fill") is None  # another kind of window


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_reads_its_cells_and_none_without_the_program(name):
    """Every new metric's reader: a number on a window of its kind that holds
    the program's spans and counts; None on the parent's window (no span,
    no host-side count), on a run without a trace, on another kind."""
    (entry,) = [m for m in SPEC["per_layer"] if m["name"] == name]
    unit = "image" if entry["moves"] == "ensemble_passes_per_s" else "epoch"
    other = "epoch" if unit == "image" else "image"
    read = harness.reader(REPO, name)
    host = HOST + [("unet.engine.predict", 0, 400)]
    assert isinstance(read(_run(_trace(host=host), unit)), (int, float))
    parent = _trace(host=[h for h in HOST if not h[0].startswith("unet.")],
                    credited={"dropblock_mask": 40})
    assert read(_run(parent, unit)) is None
    assert read(_run(None, unit)) is None
    assert read(_run(_trace(host=host), other)) is None
    assert entry["workloads"] and all(
        any(w["name"] == c for w in SPEC["workloads"]) for c in entry["workloads"])
