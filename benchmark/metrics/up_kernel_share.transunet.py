"""The decoder's upsampling merges on the hand-written kernel over all merges
in the profiled window, in % (the program's counts `up:kernel` and
`up:plain`, credited per replay). None where the program has no such count
or made no merge."""

from benchmark import spans


def read(run):
    kernel = spans.counted(run, "image", "up:kernel")
    plain = spans.counted(run, "image", "up:plain")
    if kernel is None or plain is None or kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
