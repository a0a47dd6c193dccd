"""Finds a cell's pieces by name, so that a new configuration, traffic mix,
per-layer metric or cell is a new file and a new entry, never an edit:

- ``BENCHMARK.json`` at the root: the cells (``workloads``), their
  configurations and metrics;
- ``perfbench/configs/<config>.json``: a configuration's sizes and
  precision (the path is the entry's ``file``); its ``reference`` names
  ``perfbench/reference/<reference>.py``;
- ``perfbench/traffic/<traffic>.json``: a traffic mix's parameters, read by
  the generator its ``kind`` names, ``perfbench/traffic/<kind>.py``;
- ``perfbench/cells/<cell>.json``: the cell's correctness limits;
- ``perfbench/metrics/<metric>.py``: the reader of a per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    params: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_bench(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    entry = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{entry['traffic']}.json").read_text())
    params = json.loads((root / "perfbench" / "cells" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(entry["chips"]), config=config, traffic=traffic, params=params,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_file(folder: str, name: str, root: Path = ROOT) -> ModuleType:
    """``perfbench/<folder>/<name>.py`` as a module (names may hold dots, so
    the file is loaded by its path)."""
    path = root / "perfbench" / folder / f"{name}.py"
    module = f"perfbench_{folder}_{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file for {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The reader of a per-layer metric, ``perfbench/metrics/<metric>.py``."""
    return load_file("metrics", metric, root)


def load_kind(kind: str, root: Path = ROOT) -> ModuleType:
    """The generator of a traffic kind, ``perfbench/traffic/<kind>.py``."""
    return load_file("traffic", kind, root)


def load_reference(config: dict) -> ModuleType:
    """``perfbench/reference/<config["reference"]>.py``."""
    return importlib.import_module(f"perfbench.reference.{config['reference']}")
