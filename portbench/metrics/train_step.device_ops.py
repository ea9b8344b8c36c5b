"""Device operations a training step launches, in the profiled sub-window."""

from portbench import readers


def read(ctx):
    return readers.ops_per_unit(ctx, "step")
