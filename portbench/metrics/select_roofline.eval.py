"""% of the conv sites' k-smallest selections' least time
(``work.eval_select_bounds``) in the device time of the kernels mapped
to select, per shape."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "select", "shape")
