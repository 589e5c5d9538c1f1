"""The window attention calls' summed bound (the Cell's
window_attention_bound: roofline.bound of each call's bytes and FLOP) over
the device time of their kernels in the profiled window, in %. The kernels
are SDPA's memory-efficient forward kernels, by the part of their names in
KERNELS, one a call; where the profiler lost records of them, the recorded
time stands for every call of the slice."""

KERNELS = ("fmha_cutlassF",)


def read(run):
    if run.trace is None or run.window.unit != "image" or run.work is None \
            or not hasattr(run.cell, "window_attention_bound"):
        return None
    calls, bound_s = run.cell.window_attention_bound(run.work["forwards"])
    recorded = seconds = 0
    for part in KERNELS:
        n, t = run.trace.recorded(part)
        recorded, seconds = recorded + n, seconds + t
    if recorded == 0 or seconds <= 0:
        return None
    return 100.0 * bound_s / (seconds * calls / recorded)
