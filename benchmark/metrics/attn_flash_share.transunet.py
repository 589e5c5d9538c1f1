"""The attention calls on the flash backend over all attention calls in the
profiled window, in % (the program's counts `attn:flash` and `attn:other`,
credited per replay)."""

from benchmark import spans


def read(run):
    flash = spans.counted(run, "image", "attn:flash")
    other = spans.counted(run, "image", "attn:other")
    if flash is None or other is None or flash + other == 0:
        return None
    return 100.0 * flash / (flash + other)
