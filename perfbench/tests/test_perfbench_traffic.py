"""The traffic generator's arithmetic: the photo mix's tile plan and size
classes, its schedule, percentiles over all requests, the seeded sample,
the frozen tiler against the port's, and the trace's reduction."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from conftest import ROOT

from perfbench.harness import traffic as T
from perfbench.harness.spec import load_kind
from perfbench.harness.trace import OUTSIDE, innermost, merge
from perfbench.reference import tiling

PHOTOS = json.loads((ROOT / "perfbench" / "traffic" / "photos.json").read_text())
Photos = load_kind("photos").Traffic


def test_photo_classes_tiles_and_batches():
    """Stride 80: 4, 12, 30, 48, 63, 108 tiles, or 1, 2, 4, 6, 8, 14
    batches of 8; every photo keeps the 96-px window."""
    tiles = []
    for h, w, _ in PHOTOS["sizes"]:
        window, stride, origins, _, _ = tiling.plan(h, w, PHOTOS["window"], PHOTOS["overlap"])
        assert (window, stride) == (96, 80)
        tiles.append(len(origins))
    assert tiles == [4, 12, 30, 48, 63, 108]
    assert [-(-n // PHOTOS["batch"]) for n in tiles] == [1, 2, 4, 6, 8, 14]


def test_schedule_keeps_the_mix_in_every_block_and_differs_by_seed():
    a = Photos({**PHOTOS, "schedule_blocks": 50}, seed=1, device="cpu")
    b = Photos({**PHOTOS, "schedule_blocks": 50}, seed=2, device="cpu")
    shares = [tenths for *_, tenths in PHOTOS["sizes"]]
    for block in a.order.reshape(-1, 10):
        assert [Counter(block.tolist())[c] for c in range(6)] == shares
    assert not np.array_equal(a.order, b.order)
    again = Photos({**PHOTOS, "schedule_blocks": 50}, seed=1, device="cpu")
    assert np.array_equal(a.order, again.order)
    assert all(np.array_equal(x, y) for x, y in zip(a.photos, again.photos))


def test_percentiles_fall_inside_their_size_classes():
    """Class edges at 20/40/60/80/90%: p50 lies inside the 360x480 class
    and p95 inside the 720x960 class, never on an edge; the percentile is
    taken over every request."""
    lat = [float(c) + 0.001 * i for i, c in enumerate([0, 0, 1, 1, 2, 2, 3, 3, 4, 5] * 40)]
    assert T.percentile(lat, 50) == pytest.approx(np.percentile(lat, 50))
    assert int(T.percentile(lat, 50)) == 2
    assert int(T.percentile(lat, 95)) == 5
    assert T.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_reservoir_keeps_one_uniform_draw_per_stratum():
    counts = Counter()
    for seed in range(400):
        r = T.Reservoir(np.random.default_rng(seed))
        for i in range(40):
            r.offer(i % 4, i, np.array([i]))
        assert sorted(r.kept) == [0, 1, 2, 3]
        assert all(key % 4 == s for s, (key, _) in r.kept.items())
        counts[r.kept[0][0]] += 1
    assert len(counts) == 10 and min(counts.values()) > 15  # 40 expected each


def _blur_x2(tiles):
    """A stand-in model: a 3x3 box blur (so tiles need their overlap), then
    nearest x2."""
    t = tiles.astype(np.float32)
    p = np.pad(t, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    b = sum(p[:, dy:dy + t.shape[1], dx:dx + t.shape[2]] for dy in range(3) for dx in range(3))
    return np.repeat(np.repeat((b / 9).astype(np.uint8), 2, 1), 2, 2)


@pytest.mark.parametrize("shape", [(16, 16), (20, 37), (45, 23), (9, 9), (5, 6)])
def test_frozen_tiler_equals_the_ports(shape):
    from image_super_resolution_tpu_torch.infer.tiling import upscale_tiled

    img = np.random.default_rng(0).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = upscale_tiled(lambda t: torch.from_numpy(_blur_x2(t)), img, window=16, overlap=4,
                         batch_size=3)
    got = tiling.upscale(_blur_x2, img, 16, 4, block=3)
    assert np.array_equal(got, want)


def test_merge_and_innermost():
    assert merge([(5, 9), (0, 2), (1, 3), (9, 10), (12, 13)]) == [(0, 3), (5, 10), (12, 13)]
    events = [(0, 100, "request"), (10, 50, "forward"), (10, 20, "conv"), (60, 70, "copy")]
    assert innermost(events, [5, 15, 30, 55, 65, 150]) == \
        ["request", "conv", "forward", "request", "copy", OUTSIDE]


@pytest.mark.parametrize("shape", [(5, 6), (9, 7), (20, 37)])
def test_frozen_tiler_keeps_the_downshuffle_grid(shape):
    """A small image's shrunk window stays a multiple of the model's
    downshuffle factor, as the port's tiler keeps it."""
    from image_super_resolution_tpu_torch.infer.tiling import upscale_tiled

    img = np.random.default_rng(1).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = upscale_tiled(lambda t: torch.from_numpy(_blur_x2(t)), img, window=16, overlap=4,
                         batch_size=3, grid=4)
    got = tiling.upscale(_blur_x2, img, 16, 4, block=3, grid=4)
    assert np.array_equal(got, want)
    assert tiling.plan(*shape, 16, 4, grid=4)[0] % 4 == 0


def test_tiler_host_ms_reads_idle_inside_requests_per_photo():
    from types import SimpleNamespace

    from perfbench.harness.spec import load_reader
    from perfbench.harness.trace import Trace

    reader = load_reader("tiler_host_ms")
    trace = Trace(window_s=2.0, busy_s=1.0,
                  idle_by_host={"photo/request": 0.5, OUTSIDE: 0.25, "cudaLaunchKernel": 0.1})
    ctx = SimpleNamespace(trace=trace, window={"completed": 50})
    assert reader.read(ctx, None, None) == pytest.approx(10.0)
    assert reader.read(SimpleNamespace(trace=Trace(2.0, 2.0), window={"completed": 50}),
                       None, None) == 0.0
    assert reader.read(SimpleNamespace(trace=Trace(2.0, 0.0), window={"completed": 50}),
                       None, None) is None
    assert reader.read(SimpleNamespace(trace=trace, window={"completed": 0}), None, None) is None
