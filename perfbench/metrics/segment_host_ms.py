"""segment_host_ms: host milliseconds a segment of a recurrent video model
in its three spans, ``basicvsr/flow`` (SPyNet over the segment),
``basicvsr/propagate`` (both branches' recurrences, a step for both at
once) and ``basicvsr/reconstruct`` (the per-frame reconstruction), over
the segments of the traced window: the host's dispatch of one segment,
thousands of launches. Beside a segment's device time it says whether the
host sets the pace. The log line gives the three apart. Nothing to read in
a program without the spans."""

from perfbench.harness import spans

SPANS = ("basicvsr/flow", "basicvsr/propagate", "basicvsr/reconstruct")


def snapshot():
    return spans.totals()


def read(ctx, before, after):
    calls, _ = spans.delta(before, after, SPANS[0])
    if not calls:
        return None
    parts = {name: spans.delta(before, after, name)[1] / 1e6 / calls for name in SPANS}
    segments = ctx.window["completed"] / ctx.traffic["segment"]
    ctx.log(f"segment_host_ms: {calls} segments ({segments!r} written), host ms a segment: "
            + ", ".join(f"{k} {v!r}" for k, v in parts.items())
            + f"; window {1e3 * ctx.trace.window_s / calls!r} ms a segment, device busy "
            f"{1e3 * ctx.trace.busy_s / calls!r} ms a segment")
    return sum(parts.values())
