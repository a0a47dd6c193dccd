"""A new configuration, traffic mix, traffic kind, per-layer metric and cell
are new files and new entries in BENCHMARK.json: a copy of the benchmark
gains them, finds and runs the new cell on the CPU, and no file the
benchmark already had is edited. A configuration's keys that name
``DeploySpec`` fields or ``DeployedModel`` options reach the program."""

import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

from perfbench.harness import program

NEW_READER = '''
def read(ctx, before, after):
    return float(ctx.window["completed"])
'''

# A traffic kind that no file of the benchmark knows: whole images, one at a
# time, straight through the deployed model (no tiler).
NEW_KIND = '''
import time

import numpy as np
import torch

from perfbench.harness.traffic import Reservoir, no_span
from perfbench.harness.weights import generator, substream


class Traffic:
    def __init__(self, p, seed, device):
        self.size, self.seed = p["size"], seed
        self.images = torch.randint(0, 256, (p["images"], self.size, self.size, 3),
                                    dtype=torch.uint8, generator=generator(seed, 1, device),
                                    device=device).cpu().numpy()

    def calibration(self):
        return [self.images]

    def upscaler(self, deployed):
        return deployed

    def warm(self, up):
        up(self.images[:1])

    def window(self, up, seconds, span=no_span):
        sample = Reservoir(np.random.default_rng(substream(self.seed, 2)))
        done, pixels = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            i = done % len(self.images)
            with span("whole/request"):
                out = up(self.images[i:i + 1]).cpu().numpy()[0]
            sample.offer(i, i, out)
            done += 1
            pixels += out.shape[0] * out.shape[1]
        elapsed = time.perf_counter() - t0
        return {"attempted": done, "failed": 0, "elapsed_s": elapsed, "completed": done,
                "input_pixels": done * self.size ** 2,
                "metrics": {"out_mpix_per_s": pixels / 1e6 / elapsed},
                "samples": [(self.images[i], o) for i, o in sample.kept.values()],
                "trunk_shape": (1, self.size, self.size)}

    def reference(self, apply, image, config):
        return apply(image[None])[0]
'''

SCRIPT = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
from perfbench.harness import program
from perfbench.harness.cell import run_cell
from perfbench.harness.spec import find_cell
built = {}
def system(config, weights, calibration, device):
    d = program.build(config, weights, calibration, device)
    built.update(wino_m=d.wino_m)
    return d
cell = find_cell(sys.argv[1])
assert [m["name"] for m in cell.per_layer] == ["done_count"], cell.per_layer
assert [m["name"] for m in cell.end_to_end] == ["setup_s", "out_mpix_per_s"], cell.end_to_end
r = run_cell(cell, 3, 0.3, True, time.perf_counter(), device="cpu", system=system)
print(json.dumps({**r, "built": {k: str(v) for k, v in built.items()}}))
'''

CASES = {
    # a new mix of an existing kind, on a new fast configuration
    "frames": dict(
        base="fast_x4_int8", config="fast_x1_tiny", update=dict(depth=1, scale=1,
                                                                 precision="bfloat16"),
        mix="frames_small", mix_params={"kind": "frames", "height": 8, "width": 12, "batch": 2,
                                        "pool_batches": 2, "warmup_batches": 1,
                                        "trace_seconds": 1},
        kind_file=None, built={}),
    # a new kind of traffic, on an sr configuration with keys no configuration
    # of the benchmark uses: a DeploySpec field and two DeployedModel options
    "whole": dict(
        base="sr_x4", config="sr_x4_wino_tiny", update=dict(depth=1, enchant=False, wino_m=2,
                                                            tail_fold=1),
        mix="whole_small", mix_params={"kind": "whole", "size": 8, "images": 3,
                                       "trace_seconds": 1},
        kind_file="whole", built={"wino_m": "2"}),
}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.mark.parametrize("case", sorted(CASES))
def test_new_cell_from_new_files_only(tmp_path, case):
    c = CASES[case]
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "image_super_resolution_tpu_torch",
                    tmp_path / "image_super_resolution_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)

    pb = tmp_path / "perfbench"
    cell = f"{c['config']}.{c['mix']}"
    config = json.loads((pb / "configs" / f"{c['base']}.json").read_text())
    config.update(name=c["config"], **c["update"])
    (pb / "configs" / f"{c['config']}.json").write_text(json.dumps(config))
    (pb / "traffic" / f"{c['mix']}.json").write_text(json.dumps(c["mix_params"]))
    if c["kind_file"]:
        (pb / "traffic" / f"{c['kind_file']}.py").write_text(NEW_KIND)
    (pb / "cells" / f"{cell}.json").write_text(
        json.dumps({"limits": {"rms_lsb": 3.0, "max_lsb": 20.0}}))
    (pb / "metrics" / "done_count.py").write_text(NEW_READER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": c["config"], "source": "https://arxiv.org/abs/1707.02921",
                             "file": f"perfbench/configs/{c['config']}.json",
                             "reduced": ["depth"], "why": "test"})
    bench["workloads"].append({"name": cell, "config": c["config"], "traffic": c["mix"],
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "out_mpix_per_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "done_count", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "test", "moves":
                               "out_mpix_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", SCRIPT, cell], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r
    assert r["metrics"]["done_count"]["value"] > 0
    assert {k: r["built"][k] for k in c["built"]} == c["built"]
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_program_passes_every_spec_key():
    """Keys no configuration uses today (a downshuffled fast model with a
    refinement stage) reach ``DeploySpec``; descriptive keys do not."""
    from image_super_resolution_tpu_torch.models.deploy import DeploySpec

    config = {"name": "x", "family": "fast", "depth": 1, "width": 8, "scale": 2,
              "add_rate": 0.2, "mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25],
              "downshuffle": 2, "refine_blocks": 1, "refine_width": 16,
              "dtype": "float32", "precision": "float32", "weights": "any text"}
    spec, options = program.deploy_arguments(config)
    assert spec["downshuffle"] == 2 and spec["refine_blocks"] == 1 and options == {}
    shapes = DeploySpec(**spec).build_model(device="meta").state_dict()
    g = torch.Generator().manual_seed(0)
    weights = {k: torch.rand(v.shape, generator=g) * 0.1 for k, v in shapes.items()}
    deployed = program.build(config, weights, [], torch.device("cpu"))
    assert dataclasses.asdict(deployed.spec) == {**dataclasses.asdict(DeploySpec()), **spec}
    out = deployed(torch.zeros((1, 8, 8, 3), dtype=torch.uint8))
    assert out.shape == (1, 16, 16, 3)
