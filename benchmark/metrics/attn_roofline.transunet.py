"""The attention launches' FLOP bound (QK^T and AV, 4 x B x heads x T^2 x head
size a call, at the bf16 peak) over their device time in the profiled
window, in %. The launches are the flash forward kernels (`flash_fwd` in
their names, one a call); where the profiler lost records of them, the
recorded time stands for every call of the slice."""


def read(run):
    if run.trace is None or run.window.unit != "image" or run.work is None \
            or not hasattr(run.cell, "attention_bound"):
        return None
    calls, bound_s = run.cell.attention_bound(run.work["forwards"])
    recorded, seconds = run.trace.recorded("flash_fwd")
    if recorded == 0 or seconds <= 0:
        return None
    return 100.0 * bound_s / (seconds * calls / recorded)
