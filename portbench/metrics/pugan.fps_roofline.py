"""% of a PU-GAN shape's FPS work's least time (the seed, every chunk's
net FPS and the re-stitch; ``work_pugan.fps_bounds``) in the device time
of the kernels mapped to fps."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "fps", "shape")
