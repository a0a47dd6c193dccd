"""CPU helpers for the benchmark's tests: a cell run end to end on the CPU
at tiny spatial sizes, through the same harness, traffic drivers, engine and
reference as on the card (the kernels' plain versions stand in for the
kernels). Tests that need the card are marked ``cuda`` and skip without
one."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness.cell import run_cell  # noqa: E402
from perfbench.harness.spec import find_cell  # noqa: E402

TINY_TRAFFIC = {
    "frames": {"height": 12, "width": 20, "pool_batches": 3, "warmup_batches": 1,
               "trace_seconds": 1},
    "photos": {"sizes": [[16, 16, 2], [16, 20, 2], [20, 24, 2], [24, 28, 2], [28, 32, 1],
                         [32, 36, 1]],
               "window": 16, "overlap": 4, "photos_per_size": 2, "calibration_crops": 2,
               "trace_seconds": 1},
}


def tiny_cell(name: str, root: Path = ROOT, **config):
    """The cell as BENCHMARK.json defines it, with tiny images (and any
    configuration key replaced, e.g. ``depth=1``)."""
    cell = find_cell(name, root)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    cell.config.update(config)
    return cell


def run_cpu(cell, seed: int = 7, seconds: float = 0.3, trace: bool = False, system=None):
    import time

    return run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                    system=system)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
