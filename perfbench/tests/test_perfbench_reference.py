"""The plain reference against the port's CPU path (the kernels' plain
versions), through the same traffic drivers, engine and tiler the timed
path uses; and the comparison failing where the timed path is broken."""

import pytest
import torch
from conftest import run_cpu, tiny_cell

from perfbench.harness import control, program

CELLS = ["sr_x4.frames", "sr_x4.photos", "fast_x4_int8.frames", "fast_x4_int8.photos"]


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference_at_depth_one(name):
    """sr d1 (bf16 against float32) and fast d1 (int8 against the
    reference's own quantization): correct, and close. Measured on seeds
    7-9: sr RMS 0.19-0.23 LSB, max 1; fast int8 RMS 0.008-0.017, max 1;
    the bounds leave twice that or one more LSB."""
    r = run_cpu(tiny_cell(name, depth=1))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    sr = name.startswith("sr")
    assert r["checks"]["rms_lsb"]["value"] <= (0.5 if sr else 0.05)
    assert r["checks"]["max_lsb"]["value"] <= 2


@pytest.mark.parametrize("name", ["sr_x4.frames", "fast_x4_int8.photos"])
def test_control_fails_at_full_depth(name):
    """The control (float8 for sr's bfloat16, int4 for fast's int8) in the
    program's place comes out not correct under the cell's own limits, where
    the program on the same seed is correct."""
    cell = tiny_cell(name)
    assert run_cpu(cell, seed=11)["correct"]
    r = run_cpu(cell, seed=11, system=control.build)
    assert not r["correct"]
    assert r["checks"]["rms_lsb"]["value"] > cell.params["limits"]["rms_lsb"] or \
        r["checks"]["max_lsb"]["value"] > cell.params["limits"]["max_lsb"]


class Faulty:
    """The port's deployed model with one fault planted where its output is
    produced."""

    def __init__(self, inner, fault: str):
        self.inner, self.fault, self.prev = inner, fault, None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, x):
        if self.fault == "half":  # half the batch left out, the rest repeated
            n = x.shape[0]
            y = self.inner(x[: (n + 1) // 2])
            return torch.cat([y, y])[:n]
        y = self.inner(x)
        if self.fault == "stale":  # the previous call's output, unchanged
            prev, self.prev = self.prev, y
            return prev if prev is not None and prev.shape == y.shape else y
        y = y.clone()  # "altered": one value of the batch's last output
        y[-1, y.shape[1] // 2, y.shape[2] // 2, 0] += 128
        return y


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    def build(config, weights, calibration, device):
        return Faulty(program.build(config, weights, calibration, device), fault)

    cell = tiny_cell(name, depth=1)
    r = run_cpu(cell, seconds=0.5, system=build)
    assert not r["correct"], (fault, r["checks"])
