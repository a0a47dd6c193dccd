"""The traffic generator. A mix is a data file,
``perfbench/traffic/<mix>.json``; its ``kind`` names the closed or open loop
that reads it, ``perfbench/traffic/<kind>.py``, so a new kind of traffic is
a new file. Every size, count and share comes from the mix's file, the
pixels and the order from the seed.

A kind's module defines ``Traffic(params, seed, device)`` with:

- ``calibration()``: uint8 batches an int8 build calibrates on;
- ``upscaler(deployed)``: what the loop drives (the port's engine);
- ``warm(up)``: every shape the window will use, once;
- ``window(up, seconds, span)``: the measured loop; returns ``attempted``,
  ``failed``, ``elapsed_s``, ``completed``, ``input_pixels``, the
  end-to-end ``metrics`` it measured, ``samples`` (input, output) for the
  correctness check, and the model's ``trunk_shape``;
- ``reference(apply, image, config)``: the reference's output for one
  sampled input, through the same entry (tiler or none).

The kinds here, ``frames.py`` and ``photos.py``, keep a seeded sample of
what they produced: one output per stratum (batch position or size
class), drawn uniformly over the window by reservoir sampling.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import numpy as np

from .spec import load_kind

Span = Callable[[str], contextlib.AbstractContextManager]


def no_span(_name: str):
    return contextlib.nullcontext()


class Reservoir:
    """One item per stratum, each a uniform draw over that stratum's offers."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.seen: Dict[object, int] = {}
        self.kept: Dict[object, Tuple[object, np.ndarray]] = {}

    def offer(self, stratum, key, item: np.ndarray) -> None:
        n = self.seen.get(stratum, 0) + 1
        self.seen[stratum] = n
        if self.rng.random() * n < 1.0:
            self.kept[stratum] = (key, np.array(item, copy=True))


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile over all values, linear between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def make(p: dict, seed: int, device):
    return load_kind(p["kind"]).Traffic(p, seed, device)
