"""Device-side image transforms on NHWC tensors (counterpart of the JAX
package's ``data/transforms.py``).

- normalize: uint8 -> /255 -> (x - mean) / std
- to_tanh: [0,1] -> [-1,1]
- tanh_to_uint8: round((x+1)/2 * 255) after clipping, half to even
  (``torch.round`` rounds half to even, as ``jnp.round`` does)
- rgb255_to_uint8: round(x + 255 mean) after clipping (RCAN's output)
- tanh_to_01, tanh_to_norm: the GAN phase's re-normalization of G's output
- y_channel: BT.601 luma for the eval metrics
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def constant(vals: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    """``vals`` as a 1-D tensor in ``like``'s dtype on its device (so it
    broadcasts on an NHWC tensor's channels), made once (``_const``)."""
    return _const(tuple(float(v) for v in vals), like.dtype, like.device)


@lru_cache(maxsize=64)
def _const(vals: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Made on ``device`` once: a copy from host memory per call would wait
    for the card's queued work (a training step would stall on it). Made
    outside inference mode even when first asked for inside it (serving),
    so that autograd may save it later (the GAN step divides by it)."""
    with torch.inference_mode(False):
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
    return (x - constant(mean, x)) / constant(std, x)


def to_tanh(x: torch.Tensor) -> torch.Tensor:
    """uint8 or [0,1] float -> [-1,1]."""
    return to_float01(x) * 2.0 - 1.0


def tanh_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] -> uint8 with round-half-to-even."""
    y = torch.clamp((x + 1.0) / 2.0 * 255.0, 0.0, 255.0)
    return torch.round(y).to(torch.uint8)


def rgb255_to_uint8(x: torch.Tensor, mean) -> torch.Tensor:
    """A model's output at rgb range 255 before its mean is added back ->
    uint8: ``round(clamp(x + 255 mean, 0, 255))`` in fp32, half to even.
    ``mean`` a sequence or a tensor (a program's buffer)."""
    y = x.float()
    m = mean if isinstance(mean, torch.Tensor) else constant(mean, y)
    return torch.round(torch.clamp(y + 255.0 * m, 0.0, 255.0)).to(torch.uint8)


def tanh_to_01(x: torch.Tensor) -> torch.Tensor:
    return (x + 1.0) / 2.0


def tanh_to_norm(
    x: torch.Tensor,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> torch.Tensor:
    """tanh output -> [0,1] -> (x - mean) / std (the GAN phase feeds D and
    VGG with this)."""
    y = tanh_to_01(x)
    return (y - constant(mean, y)) / constant(std, y)


def y_channel(x01: torch.Tensor, border: int = 4) -> torch.Tensor:
    """ITU-R BT.601 luma (in [16, 235]) of an NHWC [0,1] batch, ``border``
    pixels cropped: (255 x) . [65.481, 128.553, 24.966] / 255 + 16."""
    w = constant((65.481, 128.553, 24.966), x01)
    if border:
        x01 = x01[:, border:-border, border:-border, :]
    return (255.0 * x01) @ w / 255.0 + 16.0
