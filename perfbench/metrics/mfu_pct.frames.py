"""mfu_pct.frames: the whole step's share of the card's peak. The model's
operations for the frames completed in the traced window (each conv of
the reference's conv list at its resolution), each conv at the peak of the
precision it is served in, over the window's wall time."""

from perfbench.harness.spec import load_reference
from perfbench.roofline.convnet import ideal_seconds
from perfbench.roofline.peaks import peaks


def read(ctx, before, after):
    if not ctx.window["input_pixels"]:
        return None
    ref = load_reference(ctx.config)
    p = peaks(ctx.device_name)
    ideal = ideal_seconds(ref.convs(ctx.config), ref.conv_precisions(ctx.config), p,
                          ctx.window["input_pixels"])
    ctx.log(f"mfu_pct.frames: {ctx.window['completed']} frames, least {ideal!r} s at "
            f"{p['product']} peaks over {ctx.trace.window_s!r} s, card {ctx.power_limit}")
    return 100.0 * ideal / ctx.trace.window_s
