"""Running one cell of `BENCHMARK.json` once, on one card or over the ranks of
a mesh, and its result line.

Everything that belongs to one cell is found by the names in
`BENCHMARK.json`: the configuration's file (`configs[].file`), the traffic
mix's data file (`benchmark/traffic/<traffic>.json`), whose `kind` names the
module that runs it (`benchmark/kinds/<kind>.py`, cells.py), and one reader
per metric (`benchmark/metrics/<metric>.py`, whose `read(run)` returns the
number or None when the run has nothing for it to read). A cell,
configuration, traffic mix, kind or metric is added by adding files and
entries.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import cells, roofline, tracing

# top-level module names that may not be loaded in a run of the port
FORBIDDEN = ("jax", "jaxlib", "flax", "unet_research_tpu")


@dataclasses.dataclass
class Spec:
    """One cell resolved: its workload entry, configuration and traffic,
    and its metrics ({name: entry}) for runs without and with the trace."""

    root: Path
    workload: dict
    config: dict
    traffic: dict
    end_to_end: dict
    per_layer: dict


def load(root: Path, name: str) -> Spec:
    """The cell `name` of root/BENCHMARK.json, with its files read."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = by_name[name]
    (conf,) = [c for c in spec["configs"] if c["name"] == wl["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{wl['traffic']}.json").read_text())
    e2e = {m["name"]: m for m in spec["end_to_end"] if name in m.get("workloads", [name])}
    moved = set(e2e)
    layer = {m["name"]: m for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved else [])}
    return Spec(root, wl, config, traffic, e2e, layer)


def reader(root: Path, metric: str):
    """The `read` function of benchmark/metrics/<metric>.py."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def forbidden(modules) -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What the metric readers read: the cell, its set-up seconds, its window,
    the peak device memory of the fullest card, and with the trace rank 0's
    profiled window, every rank's (busy, wall) seconds and the bounds of the
    window's kernels (roofline.expected)."""

    cell: object
    setup_s: float
    window: cells.Window
    peak_bytes: int
    trace: tracing.Trace | None = None
    ranks: list | None = None
    work: dict | None = None
    expected: dict | None = None


def _gather(value, mesh):
    """Every rank's value, in rank order (one value without a mesh)."""
    if mesh is None:
        return [value]
    out = [None] * mesh.size
    torch.distributed.all_gather_object(out, value)
    return out


def join(init_method: str, rank: int, world: int, device: torch.device):
    """Join a process group of `world` ranks and return the port's mesh."""
    from unet_research_tpu_torch.parallel.mesh import make_mesh

    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(backend, init_method=init_method, world_size=world,
                                         rank=rank, timeout=datetime.timedelta(seconds=300))
    return make_mesh(device=device)


def run(spec: Spec, seed: int, seconds: float, trace: bool, device, t0: float,
        mesh=None) -> dict | None:
    """One run of the cell from process start t0 (perf_counter): set-up, the
    window, with `trace` the profiled window, then (rank 0) the check.
    Returns the result line's dict on rank 0, None on the other ranks."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    cell = cells.make_cell(spec.workload, spec.config, spec.traffic, seed, device, mesh,
                           spec.root)
    cell.setup()
    cell.sync()
    setup_s = time.perf_counter() - t0
    phases = ", ".join(f"{name} {secs:.2f} s" for name, secs in cell.phases)
    print(f"set-up {setup_s:.2f} s from process start: {phases}", file=sys.stderr)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    cpu0 = time.process_time()
    window = cell.window(seconds)
    print(f"window {window.wall_s:.3f} s of {len(window.seconds)} {window.unit}s, host CPU "
          f"{time.process_time() - cpu0:.3f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    peak = max(_gather(peak, mesh))
    result = Run(cell, setup_s, window, peak)
    if trace:
        fn, work = cell.profile_work()
        result.work, result.expected = work, roofline.expected(spec.config, work)
        result.trace, _ = tracing.profile(fn, _snapshot, any_rank=_any_rank(mesh))
        result.ranks = _gather((result.trace.busy_s, result.trace.wall_s), mesh)
    rank0 = mesh is None or mesh.rank == 0
    cell.release()
    if mesh is not None:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    if not rank0:
        return None
    return finish(spec, result, trace)


def _snapshot() -> dict:
    from unet_research_tpu_torch.ops.cuda import launches

    return launches.snapshot()


def _any_rank(mesh):
    """A function that is true on every rank when its flag is true on any."""
    if mesh is None:
        return lambda flag: flag

    def any_rank(flag: bool) -> bool:
        t = torch.tensor([int(flag)], device=mesh.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return bool(t.item())

    return any_rank


def finish(spec: Spec, result: Run, trace: bool) -> dict:
    """The metrics, the check and the result line of a finished run."""
    entries = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for name, entry in entries.items():
        value = reader(spec.root, name)(result)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    cell, window = result.cell, result.window
    on_card = cell.on_card
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(result.peak_bytes)}
    if trace:
        device["busy_s"] = sum(b for b, _ in result.ranks) / len(result.ranks)
        device["window_s"] = result.trace.wall_s
    if on_card:
        device["power"] = roofline.power_limit()
    numbers = cell.check()  # the traffic's limits name the numbers compared
    checks = {k: {"value": numbers[k], "limit": limit}
              for k, limit in spec.traffic["limits"].items()}
    wrong = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    line = {"correct": not wrong and window.failed == 0 and window.attempted > 0,
            "attempted": window.attempted, "failed": window.failed + (1 if wrong else 0),
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = result.trace.breakdown()
    line["checks"] = checks
    return line


def report(line: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
