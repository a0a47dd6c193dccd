"""device_idle_pct.frames: the share of the traced window in which no operation
(kernel, copy or fill) ran on the device."""


def read(ctx, before, after):
    if not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
