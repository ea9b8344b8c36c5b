"""% of the card's float32 peak filled by the layer equations (forward and
backward) of the steps of the traced window."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "step")
