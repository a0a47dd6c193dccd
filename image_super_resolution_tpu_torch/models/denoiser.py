"""Same-size denoisers (counterpart of the JAX package's
``models/denoiser.py``): ``family="denoise"`` and ``"denoise_legacy"``.

``Denoiser`` (reference ``Denoise``): 9x9 head -> depth/2 residual blocks
@width -> stride-2 conv to 4*width (``down``) -> 2 residual blocks @4*width
-> pixel_shuffle(2) back to full resolution + LeakyReLU(0.2) -> depth/2
residual blocks @width -> 3x3 ``trunk_conv`` -> global skip -> 9x9 tanh tail.
3,760,963 parameters at depth 16 with BN (``fused=False``).

``LegacyDenoiser``: the older revision of the reference's bundled
``model.pt``: 9x9 head -> depth residual blocks (width -> hidden -> width)
-> ``trunk_conv`` -> global skip -> 9x9 tanh tail.

NHWC in (normalized float), fp32 NHWC in [-1, 1] out, at the input's size.
Module names follow the flax names (``res0_{i}``, ``down``, ``res1_{i}``,
``res2_{i}``, ``res{i}``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.activations import apply_act
from ..ops.blocks import ResidualBlock
from ..ops.conv import ConvBlock
from ..ops.pixel_shuffle import pixel_shuffle

_ACT = ("leaky_relu", 0.2)


class Denoiser(nn.Module):
    def __init__(self, depth: int = 16, width: int = 64, fused: bool = True,
                 dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        use_bn = not fused
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        res = dict(act=_ACT, use_bn=use_bn, **kw)
        self.head = ConvBlock(3, width, 9, act=_ACT, **kw)
        for i in range(depth // 2):
            self.add_module(f"res0_{i}", ResidualBlock(width, width, 3, **res))
        self.down = ConvBlock(width, width * 4, 3, act=_ACT, stride=2, **kw)
        for i in range(2):
            self.add_module(f"res1_{i}", ResidualBlock(width * 4, width * 4, 3, **res))
        for i in range(depth // 2):
            self.add_module(f"res2_{i}", ResidualBlock(width, width, 3, **res))
        self.trunk_conv = ConvBlock(width, width, 3, act=None, use_bn=use_bn, **kw)
        self.tail = ConvBlock(width, 3, 9, act="tanh", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x.to(self.dtype))
        h = x
        for i in range(self.depth // 2):
            h = getattr(self, f"res0_{i}")(h)
        h = self.down(h)
        h = self.res1_1(self.res1_0(h))
        h = apply_act(pixel_shuffle(h, 2), _ACT)
        for i in range(self.depth // 2):
            h = getattr(self, f"res2_{i}")(h)
        x = x + self.trunk_conv(h)
        return self.tail(x).float()


class LegacyDenoiser(nn.Module):
    def __init__(self, depth: int = 8, width: int = 64, hidden: int = 32,
                 fused: bool = True, dtype=torch.float32, param_dtype=None,
                 device="cuda"):
        super().__init__()
        self.depth = depth
        self.dtype = dtype
        use_bn = not fused
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.head = ConvBlock(3, width, 9, act=_ACT, **kw)
        for i in range(depth):
            self.add_module(f"res{i}", ResidualBlock(width, hidden, 3, act=_ACT,
                                                     use_bn=use_bn, **kw))
        self.trunk_conv = ConvBlock(width, width, 3, act=None, use_bn=use_bn, **kw)
        self.tail = ConvBlock(width, 3, 9, act="tanh", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x.to(self.dtype))
        h = x
        for i in range(self.depth):
            h = getattr(self, f"res{i}")(h)
        x = x + self.trunk_conv(h)
        return self.tail(x).float()
