"""% of the cards' float32 peak filled by the layer equations of the shapes
of the traced window."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "shape")
