"""% of the card's float32 peak filled by the layer equations of the PU-Net
shapes of the traced window (``work_punet.shape_flops``)."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "shape")
