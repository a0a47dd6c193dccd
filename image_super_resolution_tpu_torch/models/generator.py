"""SR generator, fused (BN-folded) form (counterpart of the JAX package's
``models/generator.py`` with ``fused=True``).

Topology: 9x9 head conv -> depth x RRDB -> 3x3 conv -> global skip add ->
(scale//2) x sub-pixel x2 upsamplers -> 9x9 tail conv -> tanh. NHWC in,
fp32 NHWC in [-1, 1] out. ``enchant`` selects the head's LeakyReLU slope
(0.01 for the ESRGAN-style variant, 0.2 otherwise); BN is folded away, so
both variants share one graph.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.blocks import RRDB, Upsampler
from ..ops.conv import ConvBlock


class SRGenerator(nn.Module):
    def __init__(self, depth: int = 16, add_rate: float = 0.2, scale: int = 2,
                 width: int = 64, enchant: bool = False, fused: bool = True,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        if not fused:
            raise NotImplementedError(
                "the BN (training) generator is ported with training (slice 4)"
            )
        if scale not in (1, 2, 4, 8):
            raise ValueError(f"scale must be a power of two >= 1, got {scale}")
        self.depth = depth
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        head_act = ("leaky_relu", 0.01 if enchant else 0.2)
        self.head = ConvBlock(3, width, 9, act=head_act, **kw)
        for i in range(depth):
            self.add_module(f"rrdb{i}", RRDB(width, 3, act=("leaky_relu", 0.01),
                                             add_rate=add_rate, **kw))
        self.trunk_conv = ConvBlock(width, width, 3, act=None, **kw)
        self.n_up = scale // 2
        for i in range(self.n_up):
            self.add_module(f"up{i}", Upsampler(width, 2, 3,
                                                act=("leaky_relu", 0.01), **kw))
        self.tail = ConvBlock(width, 3, 9, act="tanh", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x.to(self.dtype))
        h = x
        for i in range(self.depth):
            h = getattr(self, f"rrdb{i}")(h)
        x = x + self.trunk_conv(h)
        for i in range(self.n_up):
            x = getattr(self, f"up{i}")(x)
        return self.tail(x).float()
