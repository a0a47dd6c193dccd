"""k1_roofline: K1's share of its roofline. The least time the card
needs for the RDB calls of the traced window (``roofline/k1.py`` at the
cell's trunk shape, counted by the port's ``scatter_rdb.launches``) over
the device time of the kernels K1's source compiles to."""

from perfbench.roofline import k1
from perfbench.roofline.peaks import bound_s, peaks

KERNELS = ("rdb_dense_conv",)


def snapshot():
    from image_super_resolution_tpu_torch.ops.kernels.fused_rdb import scatter_rdb

    return scatter_rdb.launches


def read(ctx, before, after):
    calls = after - before
    t = sum(s for name, s in ctx.trace.device_ops.items() if any(k in name for k in KERNELS))
    if not calls or not t:
        return None
    flops, nbytes = k1.work(*ctx.window["trunk_shape"])
    p = peaks(ctx.device_name)
    bound, by = bound_s(calls * flops, calls * nbytes, p["bfloat16"], p["bytes"])
    ctx.log(f"k1_roofline: {calls} RDB calls at {ctx.window['trunk_shape']}, least {bound!r} s "
            f"by {by} ({p['product']} peaks), kernels {t!r} s, card {ctx.power_limit}")
    return 100.0 * bound / t
