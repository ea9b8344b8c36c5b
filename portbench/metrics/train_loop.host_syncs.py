"""Host syncs a non-log step of the loop makes, from its start to the next
step's (``torch.cuda.set_sync_debug_mode("warn")``), the mean over the
traced window's non-log steps."""


def read(ctx):
    return ctx.get("counts", {}).get("host_syncs_per_step")
