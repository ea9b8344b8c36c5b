"""Median device ms a shape of PU-Net's four set-abstraction levels: the
program's ``punet.sa<l>`` spans, every chunk, summed (the profiled
sub-window); ``None`` where the program keeps no such spans."""

import re

from portbench import program_spans

LEVEL = re.compile(r"^punet\.sa\d+$")


def read(ctx):
    return program_spans.shape_median(ctx, LEVEL.match,
                                      program_spans.device_ms)
