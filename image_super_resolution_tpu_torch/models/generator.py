"""SR generator (counterpart of the JAX package's ``models/generator.py``).

Topology: 9x9 head conv -> depth x RRDB -> 3x3 conv -> global skip add ->
(scale//2) x sub-pixel x2 upsamplers -> 9x9 tail conv -> tanh. NHWC in,
fp32 NHWC in [-1, 1] out.

- ``enchant=False``: reference ``ResNet``; with ``fused=False`` (training)
  BN sits in every RRDB conv and ``trunk_conv``; head LeakyReLU(0.2).
- ``enchant=True``: reference ``EResNet``: no BN, head LeakyReLU(0.01),
  every conv kernel scaled by 0.2 at init.
- ``fused=True`` (serving, the default here) is the BN-folded graph, the
  same for both variants but for the head's slope.

``remat`` recomputes each RRDB's activations in backward
(``torch.utils.checkpoint``), as the JAX package's ``nn.remat``.

Golden parameter counts at depth 16 (``fused=False``): x2 11,735,875; x4
11,883,587; enchant x2 11,726,595.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.blocks import RRDB, Upsampler
from ..ops.conv import ConvBlock


def run_block(block: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``block(x)``, its activations recomputed in backward when ``remat``
    and the block trains."""
    if remat and block.training and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


class SRGenerator(nn.Module):
    def __init__(self, depth: int = 16, add_rate: float = 0.2, scale: int = 2,
                 width: int = 64, enchant: bool = False, fused: bool = True,
                 remat: bool = False, dtype=torch.float32, param_dtype=None,
                 device="cuda"):
        super().__init__()
        if scale not in (1, 2, 4, 8):
            raise ValueError(f"scale must be a power of two >= 1, got {scale}")
        self.depth = depth
        self.remat = remat
        self.dtype = dtype
        use_bn = not enchant and not fused
        wscale = 0.2 if enchant else 1.0
        kw = dict(weight_scale=wscale, dtype=dtype, param_dtype=param_dtype,
                  device=device)
        head_act = ("leaky_relu", 0.01 if enchant else 0.2)
        self.head = ConvBlock(3, width, 9, act=head_act, **kw)
        for i in range(depth):
            self.add_module(f"rrdb{i}", RRDB(width, 3, act=("leaky_relu", 0.01),
                                             add_rate=add_rate, use_bn=use_bn, **kw))
        self.trunk_conv = ConvBlock(width, width, 3, act=None, use_bn=use_bn, **kw)
        self.n_up = scale // 2
        for i in range(self.n_up):
            self.add_module(f"up{i}", Upsampler(width, 2, 3,
                                                act=("leaky_relu", 0.01), **kw))
        self.tail = ConvBlock(width, 3, 9, act="tanh", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x.to(self.dtype))
        h = x
        for i in range(self.depth):
            h = run_block(getattr(self, f"rrdb{i}"), h, self.remat)
        x = x + self.trunk_conv(h)
        for i in range(self.n_up):
            x = getattr(self, f"up{i}")(x)
        return self.tail(x).float()
