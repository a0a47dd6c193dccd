"""tile_efficiency_pct: the share of the output pixels the model computed
in the traced window that the tiler kept (``upscale_tiled.out_px_kept``
over ``out_px_run``). The rest is thrown away: the overlap each tile's
border adds, and the repeated last tile that pads a batch. The log line
splits the two with the tiles cut and run."""

from perfbench.harness import spans


def snapshot():
    return spans.tile_counters()


def read(ctx, before, after):
    if before is None or after is None:
        return None
    d = {k: after[k] - before[k] for k in spans.TILE_COUNTERS}
    if not d["out_px_run"]:
        return None
    value = 100.0 * d["out_px_kept"] / d["out_px_run"]
    ctx.log(f"tile_efficiency_pct: {d['out_px_kept']} output pixels kept of {d['out_px_run']} "
            f"computed; {d['tiles']} tiles cut, {d['tiles_run']} run: overlap alone keeps "
            f"{value * d['tiles_run'] / d['tiles']!r}%, batch padding runs "
            f"{100.0 * (d['tiles_run'] - d['tiles']) / d['tiles_run']!r}% of the tiles")
    return value
