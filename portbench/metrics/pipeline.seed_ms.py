"""Median ms a shape between the device events at the start and the end
of the program's ``seed`` span: seed FPS, kNN grouping, padding and
normalization (the profiled sub-window).  The stage is host-bound (its
host time reads within a few percent of this), so the number follows the
pace at which the host launches the seed's operations under the
profiler, not the device's work in them."""

from portbench import program_spans


def read(ctx):
    return program_spans.shape_median(ctx, lambda name: name == "seed",
                                      program_spans.device_ms)
