"""The port's spans and counters on the CPU: ``utils.profiling.annotate``
off and under a profiler, ``upscale_tiled``'s tile and pixel counters
against hand counts, the tiler's and the model's spans in an
``rs --profile_dir`` trace, and one span per ``Int8DeployedFast`` call."""

import json

import numpy as np
import pytest
import torch

from image_super_resolution_tpu_torch.cli import rs
from image_super_resolution_tpu_torch.infer.tiling import upscale_tiled
from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    init_fused_params,
    save_artifact,
)
from image_super_resolution_tpu_torch.models.quantized import quantize_deployed
from image_super_resolution_tpu_torch.utils import profiling
from image_super_resolution_tpu_torch.utils.profiling import annotate
from image_super_resolution_tpu_torch.utils.png import write_png
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)

COUNTERS = ("tiles", "tiles_run", "out_px_run", "out_px_kept")
MODEL_SPANS = ("model/upload", "model/forward")
TILE_SPANS = ("tile/cut", "tile/fetch", "tile/stitch")


def _totals(name):
    return list(annotate.totals.get(name, [0, 0]))


def _trace_events(logdir):
    (path,) = sorted(logdir.glob("*.pt.trace.json"))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def test_annotate_off_adds_to_totals_and_leaves_no_event(tmp_path):
    calls, ns = _totals("test/off")
    with annotate("test/off"):
        torch.ones(32, 32) @ torch.ones(32, 32)
    with annotate("test/off"):
        pass
    after = _totals("test/off")
    assert after[0] == calls + 2 and after[1] > ns
    with profiling.trace(tmp_path / "prof"):
        torch.ones(32, 32) @ torch.ones(32, 32)
    names = {e["name"] for e in _trace_events(tmp_path / "prof")}
    assert "test/off" not in names and any("mm" in n for n in names)
    assert _totals("test/off") == after


def test_annotate_under_trace_is_an_event_and_counts(tmp_path):
    calls, ns = _totals("test/on")
    with profiling.trace(tmp_path / "prof"):
        with annotate("test/on"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    events = [e for e in _trace_events(tmp_path / "prof") if e["name"] == "test/on"]
    assert len(events) == 1
    after = _totals("test/on")
    assert after[0] == calls + 1 and after[1] > ns


def test_annotate_counts_a_block_that_raises():
    calls, _ = _totals("test/raises")
    with pytest.raises(ZeroDivisionError):
        with annotate("test/raises"):
            1 / 0
    assert _totals("test/raises")[0] == calls + 1


def test_annotate_nests_a_name_in_itself_and_outlives_a_profiler(tmp_path):
    """A span inside a span of the same name counts twice, the outer one
    at least as long as the inner; a profiler opened inside a span leaves
    that span out of its trace and counts it all the same."""
    calls, ns = _totals("test/nest")
    with annotate("test/nest"):
        with annotate("test/nest"):
            inner = _totals("test/nest")[1] - ns
        with profiling.trace(tmp_path / "prof"):
            with annotate("test/nest"):
                pass
    after = _totals("test/nest")
    assert after[0] == calls + 3 and after[1] - ns >= 2 * inner
    events = [e for e in _trace_events(tmp_path / "prof") if e["name"] == "test/nest"]
    assert len(events) == 1


def _nearest_x2(tiles):
    """A stand-in model: uint8 NHWC tiles up x2 by pixel repetition."""
    return torch.from_numpy(np.ascontiguousarray(tiles.repeat(2, axis=1).repeat(2, axis=2)))


# (image h, w, window, overlap, batch, grid) -> (tiles, tiles_run, window used)
TILING = {
    # stride 8: 4 x 3 tiles, the second batch of 8 padded with 4 repeats
    "last_batch_padded": ((30, 22), 16, 4, 8, 1, (12, 16, 16)),
    # stride 8: 4 x 2 tiles fill two batches of 4
    "batches_filled": ((32, 16), 16, 4, 4, 1, (8, 8, 16)),
    # window shrunk to 11 + 2*2 = 15, rounded up to 16 on the grid of 2:
    # stride 12, one tile run as a batch of 4
    "grid_2": ((11, 9), 96, 2, 4, 2, (1, 4, 16)),
}


@pytest.mark.parametrize("case", sorted(TILING))
def test_upscale_tiled_counters_against_hand_counts(case):
    (h, w), window, overlap, batch, grid, (tiles, run, used) = TILING[case]
    image = np.random.default_rng(3).integers(0, 256, (h, w, 3), dtype=np.uint8)
    before = {k: getattr(upscale_tiled, k) for k in COUNTERS}
    spans = {k: _totals(k) for k in TILE_SPANS}
    out = upscale_tiled(_nearest_x2, image, window=window, overlap=overlap,
                        batch_size=batch, grid=grid)
    np.testing.assert_array_equal(out, image.repeat(2, axis=0).repeat(2, axis=1))
    got = {k: getattr(upscale_tiled, k) - before[k] for k in COUNTERS}
    assert got == {"tiles": tiles, "tiles_run": run, "out_px_run": run * (2 * used) ** 2,
                   "out_px_kept": 4 * h * w}
    batches = run // batch
    assert [_totals(k)[0] - spans[k][0] for k in TILE_SPANS] == [1, batches, 1]


def _profiled_rs(tmp_path, batch_size):
    spec = DeploySpec(family="sr", depth=1, width=8, scale=2)
    isr = tmp_path / "m.isr"
    save_artifact(isr, spec, init_fused_params(spec, 0))
    src = tmp_path / "a.png"
    write_png(src, np.random.default_rng(0).integers(0, 256, (30, 22, 3), dtype=np.uint8))
    rs.main(["--model", str(isr), "--src", str(src), "--device", "cpu", "--window_size", "16",
             "--overlap", "4", "--batch_size", str(batch_size), "--save_dir",
             str(tmp_path / "p.png"), "--profile_dir", str(tmp_path / "prof")])
    return _trace_events(tmp_path / "prof")


def _nested_or_disjoint(spans):
    """Every two spans of one thread are disjoint or one holds the other."""
    for i, (a0, a1) in enumerate(spans):
        for b0, b1 in spans[i + 1:]:
            if not (a1 <= b0 or b1 <= a0 or (a0 <= b0 and b1 <= a1)
                    or (b0 <= a0 and a1 <= b1)):
                return False
    return True


def test_rs_profile_dir_names_the_tiler_and_model_spans(tmp_path):
    """A 30x22 PNG in 16-px tiles at overlap 4: 12 tiles, three batches of
    4. The trace holds one cut and one stitch, and per batch one upload,
    forward and fetch, in that order on one thread; every conv of the
    model runs inside a ``model/forward``."""
    events = _profiled_rs(tmp_path, batch_size=4)
    ours = sorted((e for e in events if e["name"] in TILE_SPANS + MODEL_SPANS),
                  key=lambda e: e["ts"])
    assert [e["name"] for e in ours] == (
        ["tile/cut"] + ["model/upload", "model/forward", "tile/fetch"] * 3 + ["tile/stitch"])
    assert len({(e["pid"], e["tid"]) for e in ours}) == 1
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in ours]
    assert all(a1 <= b0 for (_, a1), (b0, _) in zip(spans, spans[1:]))
    tid = ours[0]["tid"]
    same_thread = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("tid") == tid
                   and e.get("cat") in ("user_annotation", "cpu_op")]
    assert _nested_or_disjoint(same_thread)
    forwards = [(e["ts"], e["ts"] + e["dur"]) for e in ours if e["name"] == "model/forward"]
    convs = [e for e in events if e.get("tid") == tid and "conv" in e["name"]]
    assert convs and all(any(s <= c["ts"] and c["ts"] + c["dur"] <= t for s, t in forwards)
                         for c in convs)


def _deployed(spec):
    return DeployedModel(spec, init_fused_params(spec, 0), dtype=torch.float32, device="cpu")


def test_int8_call_adds_one_forward_span():
    spec = DeploySpec(family="fast", depth=1, width=16, scale=2)
    deployed = _deployed(spec)
    x = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    quant = quantize_deployed(deployed, [x])
    before = {k: _totals(k)[0] for k in MODEL_SPANS}
    quant(x)  # a host array: one upload, one forward
    quant(torch.from_numpy(x))  # a tensor on the device already: no upload
    assert {k: _totals(k)[0] - before[k] for k in MODEL_SPANS} == {
        "model/upload": 1, "model/forward": 2}


def test_deployed_call_and_engine_upload_count_one_copy_each():
    """``DeployedModel`` uploads a host array once; the engine's frame path,
    which hands it a tensor on the device, adds a forward and no upload."""
    from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler

    spec = DeploySpec(family="sr", depth=1, width=8, scale=2)
    deployed = _deployed(spec)
    x = np.random.default_rng(6).integers(0, 256, (2, 12, 12, 3), dtype=np.uint8)
    before = {k: _totals(k)[0] for k in MODEL_SPANS}
    deployed(x)
    TiledUpscaler(deployed).upscale_batch(x)
    assert {k: _totals(k)[0] - before[k] for k in MODEL_SPANS} == {
        "model/upload": 1, "model/forward": 2}
