"""Torch-compatible initializers (counterpart of the JAX package's
``ops/initializers.py``).

Every conv kernel and bias is drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
(PyTorch's default ``kaiming_uniform_(a=sqrt(5))`` reduces to it), the
kernel then scaled by its block's ``weight_scale`` (0.2 for the "enchant"
generator). BatchNorm starts at scale 1, bias 0, mean 0, var 1 and PReLU at
0.25, as their modules build them. The draws come from one
``torch.Generator`` on the CPU, in module order, so a seed gives the same
weights on the card and on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .conv import ConvBlock


def torch_kernel_init(weight: torch.Tensor, generator: torch.Generator,
                      scale: float = 1.0) -> torch.Tensor:
    """U(-b, b) * scale for an OIHW kernel, b = 1/sqrt(I*H*W), in fp32."""
    fan_in = weight[0].numel()
    return torch_uniform(weight.shape, 1.0 / math.sqrt(fan_in), generator) * scale


def torch_bias_init(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """U(-b, b), b = 1/sqrt(fan_in); the fan-in is the kernel's."""
    return torch_uniform(shape, 1.0 / math.sqrt(max(fan_in, 1)), generator)


def torch_uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.float32).uniform_(
        -bound, bound, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Draw every ConvBlock's kernel (then bias) in module order from
    ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, ConvBlock):
            w = mod.conv.weight
            w.copy_(torch_kernel_init(w, gen, mod.weight_scale))
            if mod.conv.bias is not None:
                b = mod.conv.bias
                b.copy_(torch_bias_init(b.shape, w[0].numel(), gen))
    return model
