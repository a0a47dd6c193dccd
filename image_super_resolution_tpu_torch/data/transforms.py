"""Device-side image transforms on NHWC tensors (counterpart of the JAX
package's ``data/transforms.py``).

- normalize: uint8 -> /255 -> (x - mean) / std
- to_tanh: [0,1] -> [-1,1]
- tanh_to_uint8: round((x+1)/2 * 255) after clipping, half to even
  (``torch.round`` rounds half to even, as ``jnp.round`` does)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _c(vals: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    return _const(tuple(float(v) for v in vals), like.dtype, like.device)  # broadcasts on C


@lru_cache(maxsize=64)
def _const(vals: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Made on ``device`` once: a copy from host memory per call would wait
    for the card's queued work (a training step would stall on it)."""
    return torch.tensor(vals, dtype=dtype, device=device)


def to_float01(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] (or float) -> float [0,1]."""
    if x.dtype == torch.uint8:
        return x.to(dtype) / 255.0
    return x.to(dtype)


def normalize(
    x: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> torch.Tensor:
    """uint8/float image -> ((x/255) - mean) / std, channels-last."""
    x = to_float01(x)
    return (x - _c(mean, x)) / _c(std, x)


def to_tanh(x: torch.Tensor) -> torch.Tensor:
    """uint8 or [0,1] float -> [-1,1]."""
    return to_float01(x) * 2.0 - 1.0


def tanh_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> uint8 with round-half-to-even."""
    y = torch.clamp((x + 1.0) / 2.0 * 255.0, 0.0, 255.0)
    return torch.round(y).to(torch.uint8)
