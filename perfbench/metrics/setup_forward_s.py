"""setup_forward_s: host seconds in the span ``model/forward`` before the
traced window opens: in a run's own process, set-up's warm-up forwards,
the first forward of the graph among them (int8 calibration runs outside
the span). The log line gives every span's set-up totals."""

from perfbench.harness import spans

SPAN = "model/forward"


def snapshot():
    return spans.totals()


def read(ctx, before, after):
    if not before or not before.get(SPAN, (0, 0))[0]:
        return None
    ctx.log("setup_forward_s: spans before the window: " + ", ".join(
        f"{name} {calls} calls {ns / 1e9!r} s" for name, (calls, ns) in sorted(before.items())))
    return before[SPAN][1] / 1e9
