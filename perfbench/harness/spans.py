"""What the port counts about itself, as the per-layer metrics read it: the
spans of ``utils.profiling.annotate`` (``annotate.totals``: name -> [calls,
host ns], from the start of the process) and the tile and pixel counters of
``infer.tiling.upscale_tiled``. A port without them gives ``None``
snapshots, and the readers then return ``None``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

TILE_COUNTERS = ("tiles", "tiles_run", "out_px_run", "out_px_kept")
PHOTO_SPANS = ("tile/cut", "tile/fetch", "tile/stitch", "model/forward", "model/upload")

Totals = Dict[str, Tuple[int, int]]


def totals() -> Optional[Totals]:
    """A copy of the port's span totals."""
    from image_super_resolution_tpu_torch.utils import profiling

    found = getattr(profiling.annotate, "totals", None)
    return None if found is None else {k: (v[0], v[1]) for k, v in found.items()}


def tile_counters() -> Optional[Dict[str, int]]:
    from image_super_resolution_tpu_torch.infer.tiling import upscale_tiled

    if not all(hasattr(upscale_tiled, k) for k in TILE_COUNTERS):
        return None
    return {k: getattr(upscale_tiled, k) for k in TILE_COUNTERS}


def delta(before: Optional[Totals], after: Optional[Totals], name: str) -> Tuple[int, int]:
    """(calls, host ns) of span ``name`` between two snapshots."""
    if before is None or after is None:
        return 0, 0
    c0, n0 = before.get(name, (0, 0))
    c1, n1 = after.get(name, (0, 0))
    return c1 - c0, n1 - n0


def per_photo_ms(ctx, before, after, name: str) -> Optional[float]:
    """Host milliseconds in span ``name`` over the window, per photo
    completed."""
    calls, ns = delta(before, after, name)
    done = ctx.window["completed"]
    if not calls or not done:
        return None
    ms = ns / 1e6 / done
    ctx.log(f"{name}: {calls} spans, {ns / 1e9!r} s of host time over {done} photos: "
            f"{ms!r} ms a photo")
    return ms


def log_coverage(ctx, before, after) -> None:
    """The photo spans' host time per photo beside the window's elapsed
    time per photo."""
    done = ctx.window["completed"]
    if not done or before is None or after is None:
        return
    parts = {name: delta(before, after, name)[1] / 1e6 / done for name in PHOTO_SPANS}
    elapsed = 1e3 * ctx.window["elapsed_s"] / done
    ctx.log("photo spans per photo: " + ", ".join(f"{k} {v!r} ms" for k, v in parts.items())
            + f"; sum {sum(parts.values())!r} ms of {elapsed!r} ms elapsed a photo "
            f"({100.0 * sum(parts.values()) / elapsed!r}% covered)")
