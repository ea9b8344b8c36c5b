"""Median host ms a shape of the program's ``prepare`` and
``finish.host`` spans: host work before the upload and after the
download, in which the closed loop leaves the device nothing queued (the
profiled sub-window)."""

from portbench import program_spans


def read(ctx):
    return program_spans.shape_median(
        ctx, lambda name: name in ("prepare", "finish.host"),
        program_spans.host_ms)
