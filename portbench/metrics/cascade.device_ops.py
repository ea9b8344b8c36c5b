"""Device operations a shape launches, in the profiled sub-window."""

from portbench import readers


def read(ctx):
    return readers.ops_per_unit(ctx, "shape")
