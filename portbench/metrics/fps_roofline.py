"""% of the FPS work's least time (eval shapes; ``work.eval_fps_bounds``)
in the device time of the kernels mapped to fps."""

from portbench import readers


def read(ctx):
    return readers.roofline(ctx, "fps", "shape")
