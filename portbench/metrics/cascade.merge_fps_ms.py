"""Median device ms a shape of the cascade's merge FPS: the program's
``level<l>.merge_fps`` spans, every chunk and level, summed (the profiled
sub-window)."""

from portbench import program_spans


def merge_fps(name: str) -> bool:
    return name.startswith("level") and name.endswith(".merge_fps")


def read(ctx):
    return program_spans.shape_median(ctx, merge_fps,
                                      program_spans.device_ms)
