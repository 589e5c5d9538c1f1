"""The arithmetic that the metric readers of benchmark/metrics/ share. Each
returns None where the run has nothing for it to read: another kind of
window, no trace, or no launch of the kernel in the profiled window."""

from __future__ import annotations

import statistics

from benchmark import roofline


def median_unit(run, unit: str):
    w = run.window
    return statistics.median(w.seconds) if w.unit == unit else None


def mfu(run, unit: str, forwards_per_item: int):
    """Model FLOP of the window's work over its wall seconds and the peak of
    every card the run used, in %."""
    w, cell = run.window, run.cell
    if w.unit != unit:
        return None
    t = cell.traffic
    flop = w.work * forwards_per_item * roofline.forward_flops(cell.cfg, t["height"], t["width"])
    return 100.0 * flop / w.wall_s / (roofline.PEAK_FLOPS * cell.chips)


def roofline_share(run, group: str, unit: str):
    """The summed bounds of a kernel group's launches over their device time,
    in %. Where the profiler lost records of the group (the window was
    profiled three times), the recorded time is scaled to every launch that
    ran."""
    if run.trace is None or run.window.unit != unit or group not in run.expected:
        return None
    launches, bound_s = run.expected[group]
    recorded, seconds = run.trace.group(group)
    if recorded == 0 or seconds <= 0:
        return None
    return 100.0 * bound_s / (seconds * launches / recorded)


def idle_share(run, unit: str):
    """1 - busy / wall of the profiled window, averaged over the ranks, in %."""
    if run.trace is None or run.window.unit != unit:
        return None
    return 100.0 * statistics.mean(1.0 - busy / wall for busy, wall in run.ranks)


def peak_gib(run, unit: str):
    if run.window.unit != unit or not run.cell.on_card:
        return None
    return run.peak_bytes / 2**30


def nccl_ms_per_step(run):
    """Device milliseconds of NCCL kernels per step on rank 0."""
    if run.trace is None or run.window.unit != "epoch" or run.cell.mesh is None:
        return None
    count, seconds = run.trace.recorded("nccl")
    if count == 0:
        return None
    return 1e3 * seconds / run.work["steps"]
