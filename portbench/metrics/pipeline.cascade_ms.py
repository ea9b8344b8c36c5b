"""Mean ms of the cascade over one chunk of patches (CUDA events around
each ``Net.upsample`` call of the traced window)."""

from portbench import readers


def read(ctx):
    return readers.span_mean(ctx, "cascade")
