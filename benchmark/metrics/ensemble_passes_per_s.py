"""Member forward passes completed in the window over its wall seconds."""

def read(run):
    w = run.window
    return w.work / w.wall_s if w.unit == "image" else None
