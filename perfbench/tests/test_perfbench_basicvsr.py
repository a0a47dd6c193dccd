"""The ``basicvsr_x4`` configuration and its ``clips`` cell on the CPU: the
reference's parameters against the port's serving graph, the clips kind's
window and sample through the harness at a tiny size (the port against the
plain reference, planted faults, the new readers), K4's byte count and its
reader on a program without K4, and the operation count; on the card, the
program at the cell's own size."""

import json
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import ROOT, run_cpu

from perfbench.harness import check, control, program, traffic
from perfbench.harness.cell import run_cell
from perfbench.harness.spec import find_cell, load_kind, load_reader
from perfbench.reference import basicvsr
from perfbench.roofline import k4
from perfbench.roofline.peaks import peaks

from test_perfbench_reference import Faulty

clips = load_kind("clips")

CLIPS_TRAFFIC = json.loads((ROOT / "perfbench" / "traffic" / "clips.json").read_text())
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "basicvsr_x4.json").read_text())
TINY_CLIPS = {"height": 40, "width": 72, "segment": 5, "pool_segments": 2, "warmup_segments": 1,
              "trace_seconds": 1}


def tiny_clips(**config):
    """``basicvsr_x4.clips`` as BENCHMARK.json defines it, with 5-frame
    segments of 40 x 72 (SPyNet needs more than 32 pixels a side)."""
    cell = find_cell("basicvsr_x4.clips")
    cell.traffic.update(TINY_CLIPS)
    cell.config.update(config)
    return cell


def test_reference_parameters_are_the_serving_graphs():
    """The reference's names and shapes are the port's state dict at
    published widths: 6,291,311 parameters."""
    from image_super_resolution_tpu_torch.models.deploy import DeploySpec

    spec, _ = program.deploy_arguments(CONFIG)
    port = DeploySpec(**spec).build_model(device="meta").state_dict()
    shapes = basicvsr.param_shapes(CONFIG)
    assert {k: tuple(v.shape) for k, v in port.items()} == shapes
    assert sum(math.prod(s) for s in shapes.values()) == CONFIG["parameters"] == 6_291_311


def test_operation_count():
    """About 13.0 MFLOP an input pixel at 270 x 480 in 15-frame segments:
    the trunks 69%, the upsampler 21%, SPyNet 10%; every conv in bf16."""
    convs = basicvsr.convs(CONFIG)
    flops = {name: 2 * k * k * ci * co * res * res for name, ci, co, k, res in convs}
    total = sum(flops.values())
    assert total == pytest.approx(13.0e6, rel=3e-3)
    share = {part: sum(v for k, v in flops.items() if k.startswith(part)) / total
             for part in ("backward_trunk", "forward_trunk", "spynet")}
    assert share["backward_trunk"] + share["forward_trunk"] == pytest.approx(0.69, abs=0.01)
    assert share["spynet"] == pytest.approx(0.10, abs=0.01)
    assert set(basicvsr.conv_precisions(CONFIG).values()) == {"bfloat16"}


def test_clips_window_samples_every_position_and_is_correct():
    """Two blocks a branch on 5-frame segments: the window's sample holds
    one frame per position keyed by (pool segment, position) and carrying
    the program's frame, the reference recomputes each sampled segment in
    float32 and as the bfloat16 model, and the port (bf16) is correct,
    about 1 in units of each frame's rounding noise (seeds 7-9 at one and
    two blocks: RMS 0.99-1.015, largest region 1.27-1.38)."""
    cell = tiny_clips(blocks=2)
    r = run_cpu(cell, seconds=1.0)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 5 and r["attempted"] % 5 == 0
    assert r["checks"]["rms_lsb"]["value"] <= 1.3 and r["checks"]["max_lsb"]["value"] <= 2.0
    kind = traffic.make(cell.traffic, 7, "cpu")
    assert [kind.frame(i) for i in (0, 4, 5, 11)] == [(0, 0), (0, 4), (1, 0), (0, 1)]


@pytest.mark.parametrize("seed", [7, 8])
def test_float8_control_is_not_correct(seed):
    """The float8 model (the reference computed a precision below the
    configuration's bfloat16) in the program's place fails the RMS limit:
    3.5-4.4 noise units at this size (seeds 7-9, one and two blocks), where
    the port reads 1.00-1.02."""
    cell = tiny_clips(blocks=1)
    r = run_cpu(cell, seed=seed, seconds=1.0, system=control.build)
    assert not r["correct"]
    assert r["checks"]["rms_lsb"]["value"] > cell.params["limits"]["rms_lsb"]


def test_noise_units():
    """The kind's comparison: the sample is zeros, one a 24 x 24-pixel
    region, and the reference returns minus each region's RMS of the
    program's difference from the float32 frame over the frame's noise (the
    RMS difference of the bfloat16 model from float32, at least the
    floor), weighted so that the regions' mean square is the frame's."""
    kind = traffic.make({**CLIPS_TRAFFIC, **TINY_CLIPS}, 7, "cpu")
    plain = np.zeros((5, 160, 288, 3), np.uint8)
    rounded = plain.copy()
    rounded[1] = 2  # frame 1: noise 2 LSB; the others agree exactly (the floor)

    def apply(x):
        return plain

    apply.rounded = lambda x: rounded
    got = plain[0].copy()
    got[30, 50, 2] = 24  # one value off, in region (1, 2) of a 7 x 12 grid
    d = np.zeros((7, 12))
    d[1, 2] = 24 / 2 * np.sqrt(84 / got.size)
    assert np.allclose(-kind.reference(apply, (0, 1, got), {}), d)
    got2 = got.copy()
    got2[:] = 1  # every value 1 LSB off: the RMS is 1 / floor everywhere
    want = kind.reference(apply, (0, 0, got2), {})
    assert check.compare([(np.zeros((7, 12)), want)])["rms_lsb"] == pytest.approx(
        1 / clips.NOISE_FLOOR_LSB)
    assert check.compare([(np.zeros((7, 12)), kind.reference(apply, (0, 1, got), {}))])[
        "rms_lsb"] == pytest.approx(24 / 2 / np.sqrt(got.size))
    assert (kind.reference(apply, (0, 2, got[:-1]), {}) == -255).all()


def test_traced_run_reads_the_segment_spans():
    """A traced CPU run reads ``segment_host_ms`` from the three
    ``basicvsr/*`` spans (flow, propagate, reconstruct); ``k4_roofline``
    has nothing to read without a
    K4 launch (the plain versions count none)."""
    r = run_cpu(tiny_clips(blocks=1), seconds=1.0, trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["segment_host_ms"]["value"] > 0
    assert "k4_roofline" not in r["metrics"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_planted_fault_is_not_correct(fault):
    def build(config, weights, calibration, device):
        return Faulty(program.build(config, weights, calibration, device), fault)

    r = run_cpu(tiny_clips(blocks=1), seconds=0.5, system=build)
    assert not r["correct"], (fault, r["checks"])


def test_k4_bytes_at_the_propagation_shape():
    """One propagation warp at 270 x 480: the bf16 feature (128 B a pixel),
    the flow (8), the frame slot read (16) and the 72-channel buffer
    written (144): 38,361,600 B, 11.45 us at 3.35 TB/s."""
    nbytes = k4.work_bytes(1, 270, 480, 64, 8, 2, 2)
    assert nbytes == 270 * 480 * 296 == 38_361_600
    assert k4.work_bytes(28, 288, 480, 3, 0, 4, 4) == 28 * 288 * 480 * (12 + 8 + 12)
    t = nbytes / peaks("NVIDIA H100 80GB HBM3")["bytes"]
    assert round(t * 1e6, 2) == 11.45


def test_k4_reader_reads_nothing_without_k4(monkeypatch):
    """On a program without K4 (an earlier checkout) the reader's snapshot
    is None and its reading nothing, without raising; so is
    ``segment_host_ms`` without the spans."""
    reader = load_reader("k4_roofline")
    monkeypatch.setitem(sys.modules, "image_super_resolution_tpu_torch.ops.kernels.flow_warp",
                        None)
    assert reader.snapshot() is None
    ctx = SimpleNamespace(trace=SimpleNamespace(device_ops={}), window={}, config=CONFIG)
    assert reader.read(ctx, None, None) is None
    assert load_reader("segment_host_ms").read(ctx, None, None) is None


SEEDS = (2 ** 31 + 411, 2 ** 31 + 412, 2 ** 31 + 413)


@pytest.mark.cuda
def test_program_passes_at_cell_size(card):
    """The program at ``basicvsr_x4.clips``' own size is correct on fresh
    seeds, and the float8 control is not."""
    cell = find_cell("basicvsr_x4.clips")
    for seed in SEEDS:
        r = run_cell(cell, seed, 3.0, False, time.perf_counter(), device="cuda")
        assert r["correct"], (seed, r["checks"])
    r = run_cell(cell, SEEDS[0], 3.0, False, time.perf_counter(), device="cuda",
                 system=control.build)
    assert not r["correct"], r["checks"]
