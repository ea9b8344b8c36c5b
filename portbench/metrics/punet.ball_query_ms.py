"""Median device ms a shape of PU-Net's ball queries: the program's
``punet.sa<l>.ball_query`` spans, every chunk and level, summed (the
profiled sub-window); ``None`` where the program keeps no such spans."""

import re

from portbench import program_spans

BALL = re.compile(r"^punet\.sa\d+\.ball_query$")


def read(ctx):
    return program_spans.shape_median(ctx, BALL.match,
                                      program_spans.device_ms)
