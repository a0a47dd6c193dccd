"""forward_host_ms: host milliseconds a forward in the span
``model/forward`` (normalize, the model, uint8: the host's dispatch of one
forward), over the forwards of the traced window."""

from perfbench.harness import spans

SPAN = "model/forward"


def snapshot():
    return spans.totals()


def read(ctx, before, after):
    calls, ns = spans.delta(before, after, SPAN)
    if not calls:
        return None
    up_calls, up_ns = spans.delta(before, after, "model/upload")
    ctx.log(f"forward_host_ms: {calls} forwards, {ns / 1e9!r} s of host time; model/upload "
            f"{up_calls} copies, {up_ns / 1e9!r} s")
    return ns / 1e6 / calls
