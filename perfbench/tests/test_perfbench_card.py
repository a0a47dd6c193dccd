"""On the card, at each cell's own size and load (a short window): the
control (float8 for bfloat16, int4 for int8) in the program's place is not
correct on three seeds, and the program on the same seeds is. Run on the
card with ``python -m pytest perfbench/tests/test_perfbench_card.py``
(``perfbench/readings.py`` prints the same readings, for setting limits)."""

import time

import pytest

from perfbench.harness import control
from perfbench.harness.cell import run_cell
from perfbench.harness.spec import find_cell

SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sr_x4.frames", "fast_x4_int8.frames",
                                  "fast_x4_int8.photos", "sr_x4.photos"])
def test_control_fails_and_program_passes_at_cell_size(card, name):
    cell = find_cell(name)
    for seed in SEEDS:
        r = run_cell(cell, seed, 3.0, False, time.perf_counter(), device="cuda",
                     system=control.build)
        assert not r["correct"], (seed, r["checks"])
        r = run_cell(cell, seed, 3.0, False, time.perf_counter(), device="cuda")
        assert r["correct"], (seed, r["checks"])
