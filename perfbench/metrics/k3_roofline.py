"""k3_roofline: K3's share of its roofline. The least time the card needs
for the channel-attention blocks of the traced window (``roofline/k3.py``
at the cell's trunk shape, width and stream precision, counted by the
port's ``ca_residual.launches_by_pass``) over the device time of the
kernels K3's source compiles to. Nothing to read in a program without K3."""

from perfbench.roofline import k3
from perfbench.roofline.peaks import peaks

KERNELS = ("channel_attention_reduce", "channel_attention_scale")
PASSES = ("reduce", "scale")


def snapshot():
    try:
        from image_super_resolution_tpu_torch.ops.kernels.channel_attention import ca_residual
    except ImportError:
        return None
    return dict(ca_residual.launches_by_pass)


def read(ctx, before, after):
    if before is None or after is None:
        return None
    blocks = min(after.get(p, 0) - before.get(p, 0) for p in PASSES)
    t = sum(s for name, s in ctx.trace.device_ops.items() if any(k in name for k in KERNELS))
    if not blocks or not t:
        return None
    shape = ctx.window["trunk_shape"]
    nbytes = blocks * k3.work_bytes(ctx.config["stream"], *shape, ctx.config["width"])
    p = peaks(ctx.device_name)
    bound = nbytes / p["bytes"]
    ctx.log(f"k3_roofline: {blocks} blocks at {shape} width {ctx.config['width']} stream "
            f"{ctx.config['stream']}, least {bound!r} s by bytes ({p['product']} peaks), "
            f"kernels {t!r} s, card {ctx.power_limit}")
    return 100.0 * bound / t
