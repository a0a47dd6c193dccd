"""tiler_fetch_ms: host milliseconds a photo in the tiler's span
``tile/fetch`` (each batch's wait for its forward and its copy down, so it
carries the photo's device time), over the photos completed in the traced
window. Its log line also sums the photo spans against the window's
elapsed time a photo."""

from perfbench.harness import spans

SPAN = "tile/fetch"


def snapshot():
    return spans.totals()


def read(ctx, before, after):
    spans.log_coverage(ctx, before, after)
    return spans.per_photo_ms(ctx, before, after, SPAN)
