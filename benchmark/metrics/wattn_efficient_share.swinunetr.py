"""The attention calls on SDPA's memory-efficient backend over all attention
calls in the profiled window, in % (the program's counts `attn:efficient`,
`attn:flash` and `attn:other`, credited per replay). Every attention call of
Swin UNETR is a window attention call with a bias, which the program holds
to that backend. None where the program has no such count or made no call."""

from benchmark import spans


def read(run):
    counts = [spans.counted(run, "image", f"attn:{route}")
              for route in ("efficient", "flash", "other")]
    if None in counts or sum(counts) == 0:
        return None
    return 100.0 * counts[0] / sum(counts)
