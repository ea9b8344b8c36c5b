"""% of the wall time a unit of the traced window's steps in which no
device operation ran (the busy time from a profiled sub-window)."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx, "step")
