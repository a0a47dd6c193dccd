#!/usr/bin/env python
"""Degradation-severity sweep over trained denoise artifacts, scored by the
PyTorch port (counterpart of ``scripts/denoise_severity_sweep.py``).

Eval only: points at a finished ``torch_denoise_quality_experiment.py`` work
dir and runs the port's eval CLI per (arm, severity) with the fixed-seed
protocol. Severities come from ``data/degrade.DENOISE_SEVERITIES`` (light /
default / heavy scale the gauss variance, ISO intensity and JPEG quality
ranges together). The flags and result keys (``arm@severity`` and
``arm@severity_int8``) are the JAX script's; ``--device`` (default ``cuda``)
is passed to the eval CLI. Beside the results (default
``WORKDIR/severity_sweep.json``) it writes ``*_timings.json``: each eval's
wall seconds and launches of the two hand-written kernels.

    python scripts/torch_denoise_severity_sweep.py --workdir runs/dn \
        --severities light,heavy --int8_arms W,N
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_flagship_quality_experiment import counted_eval  # noqa: E402


def run(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", type=str, required=True,
                        help="a finished torch_denoise_quality_experiment "
                             "workdir (its *.isr artifacts and val_images.json)")
    parser.add_argument("--severities", type=str, default="light,heavy",
                        help="comma-set; 'default' is already in the "
                             "experiment's own results.json")
    parser.add_argument("--int8_arms", type=str, default="",
                        help="comma-set of arm prefixes also evaluated "
                             "through the int8 PTQ path")
    parser.add_argument("--out", type=str, default=None,
                        help="output JSON (default WORKDIR/severity_sweep.json)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the port's evaluate (cuda, or cpu)")
    opt = parser.parse_args(argv)

    from image_super_resolution_tpu_torch.cli.evaluate import main as ev

    ws = Path(opt.workdir)
    artifacts = sorted(ws.glob("*.isr"))
    if not artifacts:
        raise SystemExit(f"no .isr artifacts under {ws}")
    int8_prefixes = {a.strip().upper() for a in opt.int8_arms.split(",")
                     if a.strip()}

    results, timings = {}, {}
    for sev in [s.strip() for s in opt.severities.split(",") if s.strip()]:
        for art in artifacts:
            tag = art.stem
            ev_args = ["--model", str(art), "--denoise_eval",
                       "--severity", sev,
                       "--val_json", str(ws / "val_images.json"),
                       "--shape", "192", "--batch_size", "2",
                       "--device", opt.device]
            print(f"--- {tag} @ {sev} ---")
            key = f"{tag}@{sev}"
            results[key], timings[key] = counted_eval(ev, ev_args)
            if tag[0] in int8_prefixes:
                print(f"--- {tag} @ {sev} (int8) ---")
                results[key + "_int8"], timings[key + "_int8"] = counted_eval(
                    ev, [*ev_args, "--int8"])

    out = Path(opt.out) if opt.out else ws / "severity_sweep.json"
    out.write_text(json.dumps(results, indent=2))
    out.with_name(f"{out.stem}_timings.json").write_text(json.dumps(timings, indent=2))
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    run()
