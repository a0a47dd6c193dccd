"""The ``rcan_x4`` configuration and its cell on the CPU: the port against
the plain reference through the frames traffic, the control failing at the
published depth, planted faults, the parameter and operation counts, K3's
byte count and its reader on a program without K3; on the card, the control
and the program at each new cell's own size."""

import json
import math
import sys
import time
from types import SimpleNamespace

import pytest
from conftest import ROOT, run_cpu, tiny_cell

from perfbench.harness import control, program
from perfbench.harness.cell import run_cell
from perfbench.harness.spec import find_cell, load_reader
from perfbench.reference import rcan
from perfbench.roofline import k3
from perfbench.roofline.peaks import peaks

from test_perfbench_reference import Faulty

CONFIG = json.loads((ROOT / "perfbench" / "configs" / "rcan_x4.json").read_text())


def test_port_matches_reference_at_depth_one():
    """One group of one block (bf16 against float32): correct, and close.
    Measured on seed 7: RMS 0.214 LSB, max 1; the bounds leave twice that
    or one more LSB."""
    r = run_cpu(tiny_cell("rcan_x4.frames", depth=1, blocks=1))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["rms_lsb"]["value"] <= 0.5
    assert r["checks"]["max_lsb"]["value"] <= 2


def test_control_fails_at_full_depth():
    """All 10 groups of 20 blocks on tiny frames: the program is correct and
    the control (float8 operands in every 3x3 conv) is not, under the cell's
    own limits."""
    cell = tiny_cell("rcan_x4.frames")
    assert run_cpu(cell, seed=11)["correct"]
    r = run_cpu(cell, seed=11, system=control.build)
    assert not r["correct"]
    limits = cell.params["limits"]
    assert any(r["checks"][k]["value"] > limits[k] for k in limits)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_planted_fault_is_not_correct(fault):
    def build(config, weights, calibration, device):
        return Faulty(program.build(config, weights, calibration, device), fault)

    r = run_cpu(tiny_cell("rcan_x4.frames", depth=1, blocks=1), seconds=0.5, system=build)
    assert not r["correct"], (fault, r["checks"])


def test_parameter_and_operation_counts():
    """The published x4 model: 15,592,355 parameters; 410 3x3 convs in the
    groups (2 a block, one a group), 415 in all, about 31.8 MFLOP an input
    pixel."""
    n = sum(math.prod(s) for s in rcan.param_shapes(CONFIG).values())
    assert n == CONFIG["parameters"] == 15_592_355
    convs = rcan.convs(CONFIG)
    assert sum(name.startswith("group") for name, *_ in convs) == 10 * 41
    assert len(convs) == 415
    flops = sum(2 * k * k * ci * co * res * res for _, ci, co, k, res in convs)
    assert flops == pytest.approx(31.8e6, rel=2e-3)
    assert set(rcan.conv_precisions(CONFIG).values()) == {"bfloat16"}


def test_k3_bound_at_the_frames_shape():
    """A bf16 stream: r read twice, x read and x' written, 8 bytes an
    element: 531 MB, 0.158 ms at 3.35 TB/s; an fp32 stream 16 bytes."""
    assert k3.work_bytes("bfloat16", 8, 270, 480, 64) == 8 * 270 * 480 * 64 * 8
    assert k3.work_bytes("float32", 1, 1, 1, 64) == 64 * 16
    t = k3.work_bytes("bfloat16", 8, 270, 480, 64) / peaks("NVIDIA H100 80GB HBM3")["bytes"]
    assert round(t * 1e3, 3) == 0.158


def test_k3_reader_reads_nothing_without_k3(monkeypatch):
    """On a program without K3 (an earlier checkout) the reader's snapshot
    is None and its reading nothing, without raising."""
    reader = load_reader("k3_roofline")
    monkeypatch.setitem(sys.modules,
                        "image_super_resolution_tpu_torch.ops.kernels.channel_attention", None)
    assert reader.snapshot() is None
    ctx = SimpleNamespace(trace=SimpleNamespace(device_ops={}), window={}, config=CONFIG)
    assert reader.read(ctx, None, None) is None


SEEDS = (2 ** 31 + 311, 2 ** 31 + 312, 2 ** 31 + 313)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rcan_x4.frames", "sr_x4.frames_b32"])
def test_control_fails_and_program_passes_at_cell_size(card, name):
    cell = find_cell(name)
    for seed in SEEDS:
        r = run_cell(cell, seed, 3.0, False, time.perf_counter(), device="cuda",
                     system=control.build)
        assert not r["correct"], (seed, r["checks"])
        r = run_cell(cell, seed, 3.0, False, time.perf_counter(), device="cuda")
        assert r["correct"], (seed, r["checks"])
