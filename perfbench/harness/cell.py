"""One run of one cell: set-up, the measured window, the correctness check.

1. Set-up (``setup_s``, from the start of the process): seeded weights on
   the device, the traffic's inputs, the system under test built from them
   (and calibrated, for int8), and a warm-up over the cell's own shapes.
2. The window: ``--seconds`` of the traffic with tracing off, which gives
   the end-to-end metrics; or, with ``--trace 1``, ``trace_seconds`` of it
   (from the traffic file, at most ``--seconds``) inside one profiler
   window, which gives the per-layer metrics.
3. After the window: the peak device memory, then the system's state is
   freed and the reference recomputes each sampled output from the same
   weights and inputs; the numbers compared decide ``correct``.

``system`` replaces the port's builder: the control and the planted
faults of ``perfbench/tests`` go in the program's place through it.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from . import check, program, traffic as traffic_mod
from .spec import Cell, load_reader, load_reference
from .trace import Profiled, Trace
from .weights import make_weights


@dataclass
class Context:
    """What a per-layer metric's reader gets."""
    config: dict
    traffic: dict
    trace: Trace
    window: dict
    device_name: str
    power_limit: str

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def card(device: torch.device) -> tuple:
    """(name as torch gives it, ``nvidia-smi`` name and power limit)."""
    if device.type != "cuda":
        return "cpu", "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e!r})"
    return name, smi


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", system: Optional[Callable] = None) -> dict:
    """The result line's object, with the numbers compared under
    ``checks``, last."""
    dev = torch.device(device)
    marks = [("start", t0), ("imports", time.perf_counter())]
    ref = load_reference(cell.config)
    weights = make_weights(ref.param_shapes(cell.config), seed, dev)
    mix = traffic_mod.make(cell.traffic, seed, dev)
    calibration = mix.calibration()
    _sync(dev)
    marks.append(("weights and inputs", time.perf_counter()))
    deployed = (system or program.build)(cell.config, weights, calibration, dev)
    up = mix.upscaler(deployed)
    _sync(dev)
    marks.append(("build", time.perf_counter()))
    mix.warm(up)
    _sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    Context.log("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                        in zip(marks, marks[1:])))

    metrics, extra = {}, {}
    if trace:
        readers = {m["name"]: load_reader(m["name"]) for m in cell.per_layer}
        before = {n: getattr(r, "snapshot", lambda: None)() for n, r in readers.items()}
        with Profiled(dev) as prof:
            window = mix.window(up, min(seconds, cell.traffic["trace_seconds"]),
                                span=torch.profiler.record_function)
        after = {n: getattr(r, "snapshot", lambda: None)() for n, r in readers.items()}
    else:
        window = mix.window(up, seconds)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    name, power = card(dev)
    if trace:
        ctx = Context(cell.config, cell.traffic, prof.trace, window, name, power)
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx, before[m["name"]], after[m["name"]])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": prof.trace.busy_s, "window_s": prof.trace.window_s}
    else:
        found = {"setup_s": setup_s, **window["metrics"]}
        metrics = {m["name"]: {"value": found[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in found}

    del up, deployed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    apply = ref.make(weights, cell.config, calibration, dev)
    pairs = [(got, mix.reference(apply, image, cell.config))
             for image, got in window["samples"]]
    numbers = check.compare(pairs)
    limits = cell.params["limits"]
    correct = bool(pairs) and window["failed"] == 0 and check.within(numbers, limits)
    missing = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)} - set(metrics)
    if missing:
        Context.log(f"metrics with nothing to read in this run: {sorted(missing)}")
    Context.log(f"card: {power}; window {window['elapsed_s']!r} s, {window['completed']} "
                f"completed, {len(pairs)} outputs compared with the reference")
    result = {
        "correct": correct, "attempted": window["attempted"], "failed": window["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": name,
                   "count": 1, "memory_peak_bytes": memory_peak, **extra},
    }
    if trace:
        result["breakdown"] = prof.trace.breakdown()
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result

