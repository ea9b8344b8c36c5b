"""Median device ms a shape of PU-GAN's up-down-up expansion: the program's
``pugan.up_down_up`` spans, every chunk, summed (the profiled
sub-window); ``None`` where the program keeps no such spans."""

from portbench import program_spans


def updown(name: str) -> bool:
    return name == "pugan.up_down_up"


def read(ctx):
    return program_spans.shape_median(ctx, updown, program_spans.device_ms)
