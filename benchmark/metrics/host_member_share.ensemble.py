"""The members the engine merged from the host (its head and tail chunks) over
all members merged in the profiled window, in % (the program's counts)."""

from benchmark import spans


def read(run):
    return spans.member_share(run, "image")
