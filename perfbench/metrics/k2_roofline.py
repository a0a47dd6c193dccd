"""k2_roofline: K2's share of its roofline, its three serving variants
together. The least time for the calls of the traced window, by variant
(the port's ``conv3x3_int8.launches_by_variant``; ``roofline/k2.py`` at
the cell's trunk shape and width), over the device time of the kernels
K2's conv compiles to."""

from perfbench.roofline import k2
from perfbench.roofline.peaks import bound_s, peaks

KERNELS = ("conv3x3_int8_kernel",)


def snapshot():
    from image_super_resolution_tpu_torch.ops.kernels.matmul import conv3x3_int8

    return dict(conv3x3_int8.launches_by_variant)


def read(ctx, before, after):
    calls = {v: n - before.get(v, 0) for v, n in after.items() if n - before.get(v, 0)}
    t = sum(s for name, s in ctx.trace.device_ops.items() if any(k in name for k in KERNELS))
    if not calls or not t:
        return None
    width = ctx.config["width"]
    ops = nbytes = 0
    for variant, n in calls.items():
        o, b = k2.work(variant, *ctx.window["trunk_shape"], width, width)
        ops, nbytes = ops + n * o, nbytes + n * b
    p = peaks(ctx.device_name)
    bound, by = bound_s(ops, nbytes, p["int8"], p["bytes"])
    ctx.log(f"k2_roofline: calls {calls} at {ctx.window['trunk_shape']} width {width}, least "
            f"{bound!r} s by {by} ({p['product']} peaks), kernels {t!r} s, card {ctx.power_limit}")
    return 100.0 * bound / t
