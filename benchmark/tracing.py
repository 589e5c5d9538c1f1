"""The profiled window of a traced run: the device's busy time as the union
of its operations' intervals, kernel times by name and by kind, the longest
idle gaps named by what the host was doing, and the check of the recorded
kernels against the launches that the program credits.

The window starts after a marker kernel (torch.cuda._sleep's spin_kernel):
a profiled window can lose the first kernels it records. The profiler also
loses kernel records at random over CUDA graph replays and never adds one,
so the recorded counts of the port's kernels are held against the launches
that ops/cuda/launches.py credits over the same window (replays included),
and a window that lost records is profiled again, up to three windows in
all; the last window stands.
"""

from __future__ import annotations

import collections
import time

import torch

# kinds of device operations, by a part of their names; the first match wins
KINDS = (("K1 fused DropBlock", ("dropblock_apply_kernel",)),
         ("K2 mask producer", ("dropblock_mask_kernel",)),
         ("K3 conv3x3 (forward and dx)", ("conv3x3_wgmma_kernel", "conv3x3_kernel")),
         ("K3 backward's fold", ("conv3x3_fold_kernel",)),
         ("K4 shear fan", ("shear_",)),
         ("NCCL collectives", ("nccl",)),
         ("cuDNN/cuBLAS convs and GEMMs", ("xmma", "cudnn", "cutlass", "wgrad", "dgrad", "gemm")),
         ("reductions (GroupNorm statistics, sums, norms)", ("reduce_kernel",)),
         ("copies and dtype casts", ("copy", "memcpy", "memset")),
         ("max-pool", ("max_pool",)),
         ("optimizer (multi-tensor)", ("multi_tensor",)))

# the port's kernels by a part of their names -> the launch count credited
# for them (ops/cuda/launches.py::snapshot)
CREDITED = {"dropblock_apply_kernel": "dropblock_fused_apply",
            "dropblock_mask_kernel": "dropblock_mask",
            "conv3x3_wgmma_kernel": "path:wgmma", "conv3x3_kernel<": "path:cuda_cores",
            "conv3x3_fold_kernel": "conv3x3_pair_fold"}

# the kernel groups whose rooflines are read, by the names of their kernels
GROUPS = {"k1": ("dropblock_apply_kernel",), "k2": ("dropblock_mask_kernel",),
          "k3": ("conv3x3_wgmma_kernel", "conv3x3_kernel<", "conv3x3_fold_kernel")}


def kind_of(name: str) -> str:
    for kind, marks in KINDS:
        if any(m in name.lower() for m in marks):
            return kind
    return "other elementwise"


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals in microseconds, in
    seconds."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e6


class Trace:
    """One profiled window: wall seconds (host clock, from the marker's
    launch to the synchronisation after the work), the device operations
    after the marker, and the host's operations for naming the gaps."""

    def __init__(self, wall_s: float, device_ops: list, host_ops: list, credited: dict):
        self.wall_s = wall_s
        self.ops = device_ops  # (name, start_us, end_us)
        self.host = host_ops  # (name, start_us, end_us)
        self.credited = credited

    @property
    def busy_s(self) -> float:
        return union_seconds((s, e) for _, s, e in self.ops)

    def by_name(self) -> dict:
        """{kernel name: (count, device seconds)}."""
        out = collections.defaultdict(lambda: [0, 0.0])
        for name, s, e in self.ops:
            out[name][0] += 1
            out[name][1] += (e - s) / 1e6
        return {k: tuple(v) for k, v in out.items()}

    def recorded(self, part: str) -> tuple:
        """(count, device seconds) of the operations whose name holds `part`."""
        n, t = 0, 0.0
        for name, (count, secs) in self.by_name().items():
            if part in name:
                n, t = n + count, t + secs
        return n, t

    def lost(self) -> dict:
        """{credited count name: (credited, recorded)} where they differ."""
        out = {}
        for part, key in CREDITED.items():
            want = self.credited.get(key, 0)
            got = self.recorded(part)[0]
            if want != got:
                out[key] = (want, got)
        return out

    def group(self, name: str) -> tuple:
        """(recorded launches, device seconds) of a kernel group of GROUPS."""
        n, t = 0, 0.0
        for part in GROUPS[name]:
            a, b = self.recorded(part)
            n, t = n + a, t + b
        return n, t

    def breakdown(self) -> dict:
        """The ten kinds of device operation that took most time, and the ten
        longest idle gaps, each named by the innermost host operation open at
        its middle (seconds, unrounded)."""
        kinds = collections.Counter()
        for name, s, e in self.ops:
            kinds[kind_of(name)] += (e - s) / 1e6
        spans = sorted((s, e) for _, s, e in self.ops)
        gaps, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = []
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            open_ops = [(s, name) for name, s, e in self.host if s <= mid <= e]
            named.append([max(open_ops)[1] if open_ops else "host outside any operation",
                          (g1 - g0) / 1e6])
        return {"device_ops": [[k, v] for k, v in kinds.most_common(10)],
                "idle_gaps": named}


def _profile_once(run, snapshot) -> Trace:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        before = snapshot()
        torch.cuda._sleep(1000)  # the marker after which operations count
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = snapshot()
    credited = {k: after[k] - before.get(k, 0) for k in after}
    device, host = [], []
    for ev in prof.events():
        rng = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device.append(rng)
        else:
            host.append(rng)
    marks = [r for r in device if "spin_kernel" in r[0]]
    if len(marks) != 1:
        return Trace(wall, [], host, credited)  # the window lost its marker: measured again
    after_mark = marks[0][2]
    ops = [r for r in device if r[1] >= after_mark and "spin_kernel" not in r[0]]
    return Trace(wall, ops, host, credited)


def profile(run, snapshot, tries: int = 3, any_rank=lambda flag: flag) -> tuple:
    """Profile run() (which launches the window's work) up to `tries` times,
    until no credited kernel lost records. snapshot() reads the program's
    credited launch counts; any_rank(flag) is true where the flag is true on
    any rank of a mesh, so that every rank profiles as many windows. Returns
    (the last Trace, windows taken)."""
    for n in range(1, tries + 1):
        trace = _profile_once(run, snapshot)
        if not any_rank(not trace.ops or bool(trace.lost())):
            break
    return trace, n
