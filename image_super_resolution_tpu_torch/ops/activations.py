"""Declarative activation specs: ``None``, a name, or ``(name, param)``.

Counterpart of the JAX package's ``ops/activations.py``. The learnable
``prelu`` is a module (``PReLU``), applied by ``ConvBlock`` when its spec
names it.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device

ActSpec = Union[None, str, Tuple[str, float]]

_PLAIN = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "gelu": F.gelu,  # exact erf form, as jax.nn.gelu(approximate=False)
    "elu": F.elu,
    "relu6": F.relu6,
    "hardswish": F.hardswish,
    "hardsigmoid": F.hardsigmoid,  # relu6(x+3)/6
    "softsign": F.softsign,
    "softplus": F.softplus,
    "softmax": lambda x: torch.softmax(x, dim=-1),  # channels last, as in JAX
}


@functools.lru_cache(maxsize=None)
def dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float. JAX rounds a
    Python scalar to the array's dtype before an op (bf16(0.01) in bf16);
    torch's kernels take a Python scalar at fp32 precision, so passing the
    rounded value gives JAX's result in one vectorized pass."""
    return float(torch.tensor(value, dtype=dtype))


def apply_act(x: torch.Tensor, act: ActSpec) -> torch.Tensor:
    """Apply an activation spec to an NHWC tensor. ``None``/``False`` ->
    identity; ``True`` means SiLU, as in the reference."""
    if act is None or act is False:
        return x
    if act is True:
        act = "silu"
    name, param = (act, None) if isinstance(act, str) else act
    if name == "leaky_relu":
        # jax.nn.leaky_relu: where(x >= 0, x, slope * x), slope in x's dtype
        return F.leaky_relu(x, dtype_scalar(0.01 if param is None else param, x.dtype))
    if name in _PLAIN:
        return _PLAIN[name](x)
    # "prelu" is learnable: ConvBlock applies it as a PReLU module
    raise ValueError(f"unknown activation spec: {act!r}")


def is_prelu(act: ActSpec) -> bool:
    """True when the spec names the learnable PReLU (handled as a module)."""
    return act == "prelu" or (isinstance(act, tuple) and act[0] == "prelu")


class PReLU(nn.Module):
    """Learnable leaky slope: where(x >= 0, x, alpha * x), torch
    ``nn.PReLU``'s init 0.25 and an fp32 ``alpha`` (flax ``prelu/alpha``).
    ``channels`` 1 is one shared slope; ``channels`` n one slope per output
    channel (the last axis of the NHWC input)."""

    def __init__(self, channels: int = 1, init_value: float = 0.25,
                 device="cuda"):
        super().__init__()
        self.alpha = nn.Parameter(torch.full(
            (channels,), init_value, dtype=torch.float32,
            device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)
