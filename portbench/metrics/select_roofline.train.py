"""% of a train step's k-smallest selections' least time
(``work.train_select_bounds``) in the device time of the kernels mapped
to select."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "select", "step")
