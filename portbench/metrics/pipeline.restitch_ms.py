"""Mean ms of a shape's final re-stitch (CUDA events around the pipeline's
``fps_hierarchical`` call and its gather)."""

from portbench import readers


def read(ctx):
    return readers.span_mean(ctx, "restitch")
