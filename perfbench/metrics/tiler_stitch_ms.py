"""tiler_stitch_ms: host milliseconds a photo in the tiler's span
``tile/stitch`` (the concatenate of the output tiles, the crop loop and
the canvas), over the photos completed in the traced window."""

from perfbench.harness import spans

SPAN = "tile/stitch"


def snapshot():
    return spans.totals()


def read(ctx, before, after):
    return spans.per_photo_ms(ctx, before, after, SPAN)
