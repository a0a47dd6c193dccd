"""Seeded weights and inputs, made on the device in a few large calls.

Every conv kernel and bias is drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
PyTorch's default ``Conv2d`` initialization, with fan_in = Cin * k * k of
its kernel. All leaves come out of one ``torch.rand`` call on a
``torch.Generator`` of the device, seeded from ``--seed``; inputs use
generators seeded from the same seed through ``substream``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_MASK = (1 << 63) - 1


def substream(seed: int, k: int) -> int:
    """A distinct 63-bit seed for stream ``k`` of ``seed`` (any integer)."""
    return (seed * 0x9E3779B97F4A7C15 + k * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) & _MASK


def generator(seed: int, k: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(substream(seed, k))
    return g


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``. ``shapes`` holds OIHW kernels
    ``<conv>.weight`` and their biases ``<conv>.bias``."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    bounds = []
    for n in names:
        kernel = shapes[n.rsplit(".", 1)[0] + ".weight"]
        bounds.append(1.0 / math.sqrt(kernel[1] * kernel[2] * kernel[3]))
    u = torch.rand(sum(sizes), generator=generator(seed, 0, device), device=device)
    per = torch.repeat_interleave(torch.tensor(bounds, device=device),
                                  torch.tensor(sizes, device=device))
    flat = (u * 2.0 - 1.0) * per
    return {n: t.view(shapes[n]) for n, t in zip(names, torch.split(flat, sizes))}
