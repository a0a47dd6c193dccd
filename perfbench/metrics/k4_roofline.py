"""k4_roofline: K4's share of its roofline. The least time the card needs
for the flow warps of the traced window (``roofline/k4.py``, counted by
shape in the port's ``flow_warp.launches_by_shape``: the propagation's
warps into the trunk's input buffer and SPyNet's warps of its pyramid)
over the device time of the kernels K4's source compiles to. Nothing to
read in a program without K4."""

from perfbench.roofline import k4
from perfbench.roofline.peaks import peaks

KERNELS = ("flow_warp_kernel",)


def snapshot():
    try:
        from image_super_resolution_tpu_torch.ops.kernels.flow_warp import flow_warp
    except ImportError:
        return None
    return dict(flow_warp.launches_by_shape)


def read(ctx, before, after):
    if before is None or after is None:
        return None
    calls = {key: n - before.get(key, 0) for key, n in after.items() if n - before.get(key, 0)}
    t = sum(s for name, s in ctx.trace.device_ops.items() if any(k in name for k in KERNELS))
    if not calls or not t:
        return None
    nbytes = sum(n * k4.work_bytes(*key) for key, n in calls.items())
    p = peaks(ctx.device_name)
    bound = nbytes / p["bytes"]
    ctx.log(f"k4_roofline: {sum(calls.values())} warps in {len(calls)} shapes, {nbytes} B, least "
            f"{bound!r} s by bytes ({p['product']} peaks), kernels {t!r} s, card "
            f"{ctx.power_limit}; by shape (n, h, w, c, frame, x bytes, out bytes): {calls}")
    return 100.0 * bound / t
