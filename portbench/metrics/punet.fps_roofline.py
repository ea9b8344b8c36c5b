"""% of a PU-Net shape's FPS work's least time (the seed, every chunk's
four SA levels and the re-stitch; ``work_punet.fps_bounds``) in the device
time of the kernels mapped to fps."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "fps", "shape")
