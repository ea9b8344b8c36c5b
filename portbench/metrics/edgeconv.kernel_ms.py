"""Device ms a shape of the edge-conv chain kernel: the profiled
operations the kernel map assigns to edgeconv, over the profiled shapes.
``None`` where none ran (a program that keeps the eval cascade's edge
convs on the plain PyTorch chain)."""

from portbench import readers


def read(ctx):
    if ctx.get("unit") != "shape" or ctx.get("profile") is None:
        return None
    t = readers.op_seconds(ctx, "edgeconv")
    return 1000.0 * t / ctx["units_profiled"] if t > 0 else None
