"""Mean ms of a shape's all-gather on rank 0 (CUDA events around
``Mesh.all_gather``), the wait for the slowest rank included."""

from portbench import readers


def read(ctx):
    return readers.span_mean(ctx, "allgather")
