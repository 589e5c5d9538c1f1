"""TransUNet's model FLOP of the window's member forwards (reference/transunet.py
model_flops on the padded canvas) over its wall seconds, as a share of the
card's bf16 peak."""

from benchmark import roofline


def read(run):
    w, cell = run.window, run.cell
    if w.unit != "image" or not hasattr(cell, "member_flops"):
        return None
    return 100.0 * w.work * cell.member_flops() / w.wall_s / (roofline.PEAK_FLOPS * cell.chips)
