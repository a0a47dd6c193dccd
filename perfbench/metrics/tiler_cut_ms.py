"""tiler_cut_ms: host milliseconds a photo in the tiler's span
``tile/cut`` (reflect pad, tile stack and batch padding), over the photos
completed in the traced window."""

from perfbench.harness import spans

SPAN = "tile/cut"


def snapshot():
    return spans.totals()


def read(ctx, before, after):
    return spans.per_photo_ms(ctx, before, after, SPAN)
