"""% of the least time of a PU-GAN shape's attention units
(``work_pugan.attention_bound``: two a patch, every patch that runs) in
the device time of the program's ``pugan.up<j>.attention`` spans, summed
over a shape's chunks (median over the profiled shapes); ``None`` where
the program keeps no such spans."""

import re

from portbench import program_spans

ATTENTION = re.compile(r"^pugan\.up\d+\.attention$")


def read(ctx):
    bound = ctx.get("work", {}).get("attention")
    if bound is None:
        return None
    ms = program_spans.shape_median(ctx, ATTENTION.match,
                                    program_spans.device_ms)
    if not ms:
        return None
    return 100.0 * bound.seconds * 1000.0 / ms
