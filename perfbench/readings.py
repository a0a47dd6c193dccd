"""The readings that the correctness limits are set from, at a cell's own
size and load: the numbers compared (``rms_lsb``, ``max_lsb``) for sound
runs of the program and for the control (``harness/control.py``), each
over its own seeds, in one process with a short window per seed:

    python3 perfbench/readings.py --workload sr_x4.frames --seconds 3 \
        --seeds 11,12,13 --control-seeds 21,22,23 [--out chiprun_out/r.jsonl]

One JSON line per run on standard output (and appended to ``--out``). The
benchmark's own runs (``run.py``) never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import control
    from perfbench.harness.cell import run_cell
    from perfbench.harness.spec import find_cell

    cell = find_cell(args.workload)
    runs = [("program", int(s), None) for s in args.seeds.split(",") if s]
    runs += [("control", int(s), control.build) for s in args.control_seeds.split(",") if s]
    for side, seed, system in runs:
        t0 = time.perf_counter()
        r = run_cell(cell, seed, args.seconds, False, t0, device=args.device, system=system)
        line = json.dumps({"workload": args.workload, "side": side, "seed": seed,
                           "correct": r["correct"], "attempted": r["attempted"],
                           "failed": r["failed"], "checks": r["checks"],
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
