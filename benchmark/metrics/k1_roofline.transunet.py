"""K1's launches' byte bound at TransUNet's own mask sites (reference/
transunet.py mask_sites, roofline.k1_bound's bytes) over their device time
in the profiled window, in %. Where the profiler lost records of K1, the
recorded time stands for every launch that ran."""


def read(run):
    if run.trace is None or run.window.unit != "image" or run.work is None \
            or not hasattr(run.cell, "k1_bound"):
        return None
    launches, bound_s = run.cell.k1_bound(run.work["forwards"])
    recorded, seconds = run.trace.group("k1")
    if recorded == 0 or seconds <= 0:
        return None
    return 100.0 * bound_s / (seconds * launches / recorded)
