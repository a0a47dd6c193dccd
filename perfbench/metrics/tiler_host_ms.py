"""tiler_host_ms: the host's own time per photo that holds the device
back: the idle gaps of the traced window that fall inside the benchmark's
``photo/request`` span and outside any profiled operation (the tiler's
numpy pad, stack, concatenate and stitch, and the Python around them),
over the photos completed in the window. A per-layer reading beside the
photo cells' latencies; the profiler adds some host time of its own."""

SPAN = "photo/request"


def read(ctx, before, after):
    done = ctx.window["completed"]
    if not done or not ctx.trace.busy_s:  # no photo, or no device work to hold back
        return None
    return 1e3 * ctx.trace.idle_by_host.get(SPAN, 0.0) / done
