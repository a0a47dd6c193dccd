"""The readers of the port's spans and tiler counters: each on hand-made
snapshots and context, a port without the spans (every reader silent),
and a photo cell run on the CPU with ``--trace 1`` that reads all six."""

import pytest
from conftest import run_cpu, tiny_cell

from perfbench.harness.cell import Context
from perfbench.harness.spec import load_reader
from perfbench.harness.trace import Trace

NEW = ("tile_efficiency_pct", "tiler_cut_ms", "tiler_stitch_ms", "tiler_fetch_ms",
       "forward_host_ms", "setup_forward_s")


class _Ctx(Context):
    """A reader's context that keeps its log lines."""

    def log(self, msg):
        self.lines.append(msg)


def _ctx(completed=4, elapsed_s=0.5):
    ctx = _Ctx(config={}, traffic={}, trace=Trace(window_s=elapsed_s, busy_s=0.1),
               window={"completed": completed, "elapsed_s": elapsed_s}, device_name="cpu",
               power_limit="cpu")
    ctx.lines = []
    return ctx


BEFORE = {"model/forward": (10, 9_000_000_000), "model/upload": (10, 50_000_000),
          "tile/cut": (3, 3_000_000), "tile/fetch": (12, 40_000_000),
          "tile/stitch": (3, 9_000_000)}
AFTER = {"model/forward": (30, 9_020_000_000), "model/upload": (30, 51_000_000),
         "tile/cut": (7, 7_000_000), "tile/fetch": (32, 120_000_000),
         "tile/stitch": (7, 25_000_000), "photo/other": (1, 1)}


@pytest.mark.parametrize("name,want", [
    ("tiler_cut_ms", 4_000_000 / 1e6 / 4),
    ("tiler_stitch_ms", 16_000_000 / 1e6 / 4),
    ("tiler_fetch_ms", 80_000_000 / 1e6 / 4),
    ("forward_host_ms", 20_000_000 / 1e6 / 20),
    ("setup_forward_s", 9.0),
])
def test_span_readers_on_hand_made_snapshots(name, want):
    ctx = _ctx()
    assert load_reader(name).read(ctx, BEFORE, AFTER) == pytest.approx(want)
    assert ctx.lines


def test_fetch_reader_logs_the_coverage():
    """(1 + 4 + 20 + 5 + 0.25) ms of spans a photo against 125 ms elapsed."""
    ctx = _ctx()
    load_reader("tiler_fetch_ms").read(ctx, BEFORE, AFTER)
    (line,) = [s for s in ctx.lines if s.startswith("photo spans")]
    assert f"sum {30.25!r} ms of {125.0!r} ms" in line and f"({24.2!r}% covered)" in line


def test_setup_reader_logs_every_span():
    ctx = _ctx()
    load_reader("setup_forward_s").read(ctx, BEFORE, AFTER)
    assert all(name in ctx.lines[0] for name in BEFORE)


def test_tile_efficiency_on_hand_made_counters():
    """The photo mix's block: 2,226,368 input pixels kept of 384 tiles run
    of 96^2 at x4; 359 tiles cut."""
    before = {"tiles": 10, "tiles_run": 16, "out_px_run": 5, "out_px_kept": 3}
    after = {"tiles": 10 + 359, "tiles_run": 16 + 384, "out_px_run": 5 + 384 * 384 ** 2,
             "out_px_kept": 3 + 2_226_368 * 16}
    ctx = _ctx()
    value = load_reader("tile_efficiency_pct").read(ctx, before, after)
    assert value == pytest.approx(62.91, abs=0.005)
    assert "overlap alone keeps 67.29" in ctx.lines[0]


COUNTERS = {"tiles": 4, "tiles_run": 8, "out_px_run": 80, "out_px_kept": 40}
# per reader: snapshots of a window in which its span or counter did not move
STILL = {"tile_efficiency_pct": (COUNTERS, COUNTERS), "setup_forward_s": ({}, AFTER),
         **{n: (BEFORE, BEFORE) for n in NEW[1:-1]}}


@pytest.mark.parametrize("name", NEW)
def test_readers_are_silent_without_the_ports_spans(name):
    """A port without the spans and counters gives None snapshots; a window
    in which they did not move (or a set-up without a forward) reads
    nothing."""
    reader = load_reader(name)
    assert reader.read(_ctx(), None, None) is None
    assert reader.read(_ctx(), *STILL[name]) is None


def test_photo_cell_on_the_cpu_reads_all_six():
    cell = tiny_cell("fast_x4_int8.photos", depth=1)
    r = run_cpu(cell, trace=True, seconds=0.5)
    assert r["correct"], r
    got = r["metrics"]
    assert set(NEW) <= set(got), got
    assert 0 < got["tile_efficiency_pct"]["value"] < 100
    assert all(got[n]["value"] > 0 for n in NEW)
    assert got["tile_efficiency_pct"]["unit"] == "%" and got["setup_forward_s"]["unit"] == "s"
