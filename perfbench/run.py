"""Run one cell of the port's benchmark once, on the machine it starts on:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``, each number the
correctness check compared beside its limit; the same numbers close
standard error. A run exits non-zero and prints no result without CUDA or
with fewer cards than the cell asks for, and when JAX or the JAX package
is loaded once the window has closed. Cells, configurations, traffic and
metrics are found by name: see ``harness/spec.py`` and PERF.md.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Kernel caches at fixed paths inside the checkout: only a checkout's
    # first run builds (the port's nvcc output goes to build/kernels/).
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness.cell import Context, run_cell
    from perfbench.harness.guard import forbidden_loaded
    from perfbench.harness.spec import find_cell

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), T0)
    found = forbidden_loaded()
    if found:
        print(f"modules that no run may load are loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        Context.log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
