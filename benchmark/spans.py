"""The port's own spans in a profiled window, and the card's idle time that
the host caused, put down to the span that caused it.

The port marks its host phases with `unet.*` spans (unet_research_tpu_torch/
spans.py): torch.profiler records them beside the device operations and
the CUDA runtime calls, on the profiler's one clock, so a Trace's `host`
list holds them with the launch calls and its `ops` the device operations.

Host-bound idle time (`host_idle`), within the window's device operations:

- A gap between device operations (their union) is host-bound when a
  launch call (`LAUNCHES`: kernel and graph launches, asynchronous copies
  and memsets) starts or ends inside it: the work that ended the gap
  reached the card only then. A launch that ends after its operation
  started still starts inside the gap, which is why both ends count. Such
  a gap is put down to the innermost `unet.` span open at the latest such
  start or end, or to `OUTSIDE` where none is open. Every other gap is
  device-side: its next operation was already queued, as between the
  kernels of a replayed CUDA graph.
- The lead-in, from the first root span's start to the first device
  operation, is host-bound, put down to the innermost span open when that
  operation starts: the card waited for what the host did until then. (Its
  launch call may be missing: the profiler loses records, and a lost launch
  turns a host-bound gap into a device-side one, never the reverse.)

Without the profiler's correlation ids, which tie each device operation to
the launch call that issued it, the rule can misclassify a gap in which a
launch of some later operation happens to start or end (the host runs
ahead of the card in a replay loop), or call device-side a gap that a
blocking call spans whole. Keeping the ids in benchmark/tracing.py's Trace,
a change to the benchmark itself, would make the rule exact.

The readers return None where the window holds no span or count of the
program (a program that has none, or no trace).
"""

from __future__ import annotations

import bisect
import collections

PREFIX = "unet."
OUTSIDE = "outside the program"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
            "cudaMemsetAsync")


def spans(trace) -> list:
    """The program's spans of the window: (name without the prefix, start
    us, end us), by start."""
    return sorted(((name[len(PREFIX):], s, e) for name, s, e in trace.host
                   if name.startswith(PREFIX)), key=lambda r: (r[1], -r[2]))


def innermost(spans_: list, t: float):
    """The name of the innermost span open at t (the latest started of
    those open; spans on one thread nest), or OUTSIDE."""
    best = None
    for name, s, e in spans_:
        if s > t:
            break
        if t <= e:
            best = name
    return OUTSIDE if best is None else best


def gaps(ops) -> list:
    """The (start, end) gaps between the union of the device operations."""
    out, end = [], None
    for s, e in sorted((s, e) for _, s, e in ops):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def host_idle(trace) -> dict | None:
    """{span name or OUTSIDE: host-bound idle seconds} of the window (module
    docstring), or None where it holds no span of the program or no device
    operation."""
    spans_ = spans(trace)
    if not spans_ or not trace.ops:
        return None
    points = sorted(t for name, s, e in trace.host if name.startswith(LAUNCHES) for t in (s, e))
    out = collections.Counter()
    first_op = min(s for _, s, _ in trace.ops)
    if spans_[0][1] < first_op:
        out[innermost(spans_, first_op)] += (first_op - spans_[0][1]) / 1e6
    for g0, g1 in gaps(trace.ops):
        i = bisect.bisect_left(points, g1) - 1  # the latest launch start or end before g1
        if i >= 0 and points[i] > g0:
            out[innermost(spans_, points[i])] += (g1 - g0) / 1e6
    return dict(out)


def _traced(run, unit: str) -> bool:
    return run.trace is not None and run.window.unit == unit


def host_idle_share(run, unit: str):
    """Host-bound idle seconds over the window's wall seconds, in %."""
    if not _traced(run, unit):
        return None
    idle = host_idle(run.trace)
    return None if idle is None else 100.0 * sum(idle.values()) / run.trace.wall_s


def span_ms(run, unit: str, name: str, over=sum):
    """`over` of the durations of the window's spans `name`, in ms."""
    if not _traced(run, unit):
        return None
    ms = [(e - s) / 1e3 for n, s, e in spans(run.trace) if n == name]
    return over(ms) if ms else None


def counted(run, unit: str, key: str):
    """The program's count `key` over the window (ops/cuda/launches.py)."""
    if not _traced(run, unit):
        return None
    return run.trace.credited.get(key)


def member_share(run, unit: str):
    """Members merged from the host over all members merged, in %."""
    host, program = counted(run, unit, "members:host"), counted(run, unit, "members:program")
    if host is None or program is None or host + program == 0:
        return None
    return 100.0 * host / (host + program)
