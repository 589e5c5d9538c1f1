"""Training images stepped in the window (all ranks) over its wall seconds."""

def read(run):
    w = run.window
    return w.work / w.wall_s if w.unit == "epoch" else None
