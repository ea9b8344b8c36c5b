"""% of the card's float32 peak filled by the layer equations of the PU-GAN
shapes of the traced window (``work_pugan.shape_flops``)."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "shape")
