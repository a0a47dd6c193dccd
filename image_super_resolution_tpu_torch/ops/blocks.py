"""Residual and dense building blocks on NHWC tensors (counterpart of the
JAX package's ``ops/blocks.py``).

- ResidualBlock: x + conv(act) -> conv(no act).
- RDB: 4 growth convs with dense concatenation + fusion conv, residual-scaled.
- RRDB: 3 sequential RDBs, residual-scaled, growth = features // 2.
- Upsampler: conv -> pixel_shuffle -> act (never BN).

Module names follow the flax names (``conv0``..``conv3``, ``conv_fuse``,
``rdb0``..``rdb2``, ``conv``) so a flax tree loads without renaming.
``use_bn``, ``weight_scale``, ``dtype`` and ``param_dtype`` reach every
ConvBlock, as in the JAX modules.
"""

from __future__ import annotations

import torch
from torch import nn

from .activations import ActSpec, apply_act, dtype_scalar
from .conv import ConvBlock
from .pixel_shuffle import pixel_shuffle


def scale_residual(h: torch.Tensor, add_rate: float) -> torch.Tensor:
    """``h * jnp.asarray(add_rate, h.dtype)``: the rate rounded to h's
    dtype first (bf16(0.2) in bf16), unlike ``h * 0.2``."""
    return h * dtype_scalar(add_rate, h.dtype)


class ResidualBlock(nn.Module):
    """x + conv(act) -> conv(no act). Reference ResidualBlock1."""

    def __init__(self, features: int, hidden: int, kernel: int = 3,
                 act: ActSpec = ("leaky_relu", 0.2), use_bn: bool = True,
                 dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        kw = dict(use_bn=use_bn, dtype=dtype, param_dtype=param_dtype, device=device)
        self.conv0 = ConvBlock(features, hidden, kernel, act=act, **kw)
        self.conv1 = ConvBlock(hidden, features, kernel, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv1(self.conv0(x))


class RDB(nn.Module):
    """Residual Dense Block with residual scaling."""

    def __init__(self, in_features: int, growth: int, kernel: int = 3,
                 act: ActSpec = ("leaky_relu", 0.01), add_rate: float = 0.2,
                 use_bn: bool = False, weight_scale: float = 1.0,
                 dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        self.add_rate = add_rate
        kw = dict(use_bn=use_bn, weight_scale=weight_scale, dtype=dtype,
                  param_dtype=param_dtype, device=device)
        for i in range(4):
            self.add_module(f"conv{i}", ConvBlock(
                in_features + i * growth, growth, kernel, act=act, **kw))
        self.conv_fuse = ConvBlock(in_features + 4 * growth, in_features,
                                   kernel, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(4):
            inp = torch.cat(feats, dim=-1) if len(feats) > 1 else x
            feats.append(getattr(self, f"conv{i}")(inp))
        fused = self.conv_fuse(torch.cat(feats, dim=-1))
        return scale_residual(fused, self.add_rate) + x


class RRDB(nn.Module):
    """Residual-in-Residual Dense Block: 3 x RDB, residual-scaled."""

    def __init__(self, features: int, kernel: int = 3,
                 act: ActSpec = ("leaky_relu", 0.01), add_rate: float = 0.2,
                 use_bn: bool = False, weight_scale: float = 1.0,
                 dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        if not 0.0 < add_rate <= 1.0:
            raise ValueError(f"add_rate must be in (0, 1], got {add_rate}")
        self.add_rate = add_rate
        for i in range(3):
            self.add_module(f"rdb{i}", RDB(
                features, features // 2, kernel, act=act, add_rate=add_rate,
                use_bn=use_bn, weight_scale=weight_scale, dtype=dtype,
                param_dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.rdb2(self.rdb1(self.rdb0(x)))
        return scale_residual(h, self.add_rate) + x


class Upsampler(nn.Module):
    """Sub-pixel x``scale`` upsampler: conv(C -> C*s^2) -> pixel_shuffle -> act."""

    def __init__(self, features: int, scale: int = 2, kernel: int = 3,
                 act: ActSpec = ("leaky_relu", 0.01), weight_scale: float = 1.0,
                 dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        self.scale = scale
        self.act = act
        self.conv = ConvBlock(features, features * scale ** 2, kernel, act=None,
                              weight_scale=weight_scale, dtype=dtype,
                              param_dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(pixel_shuffle(self.conv(x), self.scale), self.act)
