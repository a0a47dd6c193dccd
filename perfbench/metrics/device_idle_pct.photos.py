"""device_idle_pct.photos: the share of the traced window in which no operation
(kernel, copy or fill) ran on the device, under photo traffic: how far the host
tiler and dispatch hold the card back."""


def read(ctx, before, after):
    if not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
