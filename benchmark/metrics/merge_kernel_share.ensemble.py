"""The U-Net's skip merges in K1's merge mode over all its merges on the fused
route in the profiled window, in % (the program's counts `merge:kernel` and
`merge:plain`, credited per replay). None where the program has no such count
or made no such merge."""

from benchmark import spans


def read(run):
    kernel = spans.counted(run, "image", "merge:kernel")
    plain = spans.counted(run, "image", "merge:plain")
    if kernel is None or plain is None or kernel + plain == 0:
        return None
    return 100.0 * kernel / (kernel + plain)
