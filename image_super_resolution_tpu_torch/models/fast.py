"""The fast families' generator (counterpart of the JAX package's
``models/fast.py``): ``family="fast"`` (x2, x4) and ``"denoise_fast"`` (x1).

head 3x3 -> depth x FastResBlock (two 3x3 width->width convs, residual
scaled) -> trunk_conv -> global skip -> tail. NHWC in (normalized float),
fp32 NHWC in [-1, 1] out. With ``downshuffle`` f > 1 the input is
edge-padded to multiples of f and space-to-depth'ed, so the trunk runs at
1/f resolution, and the tail shuffles by scale*f; the padding is cropped
at output scale. The tail is either born-folded (3x3 conv to
3*(scale*f)^2 channels, tanh, one shuffle) or, with ``refine_blocks``, a
projection, one shuffle, narrow residual blocks at output resolution and a
3-channel tanh conv.

The graph is BN-free, so it trains as it serves: with ``param_dtype``
fp32 master weights and, with ``remat``, each block's activations
recomputed in backward (the trunk's and the refinement tail's), as the JAX
package's ``nn.remat``.

Module names follow the flax names (``head``, ``block{i}/conv{0,1}``,
``trunk_conv``, ``refine_proj``, ``refine{i}``, ``tail``), so an ``.isr``
tree loads without renaming.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import scale_residual
from ..ops.conv import ConvBlock
from ..ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from .generator import run_block

_LEAKY = ("leaky_relu", 0.01)


def downshuffle_front(x: torch.Tensor, f: int) -> torch.Tensor:
    """Edge-pad H, W of an NHWC tensor up to multiples of ``f``
    (``jnp.pad(mode="edge")``), then space-to-depth by ``f``."""
    if f == 1:
        return x
    pad_h, pad_w = -x.shape[1] % f, -x.shape[2] % f
    if pad_h or pad_w:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                  mode="replicate").permute(0, 2, 3, 1)
    return pixel_unshuffle(x, f)


class FastResBlock(nn.Module):
    """conv3x3 -> leaky -> conv3x3, residual-scaled: x + add_rate * h."""

    def __init__(self, features: int, add_rate: float = 0.2,
                 dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__()
        self.add_rate = add_rate
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.conv0 = ConvBlock(features, features, 3, act=_LEAKY, **kw)
        self.conv1 = ConvBlock(features, features, 3, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + scale_residual(self.conv1(self.conv0(x)), self.add_rate)


class FastSRGenerator(nn.Module):
    def __init__(self, depth: int = 14, add_rate: float = 0.2, scale: int = 4,
                 width: int = 128, downshuffle: int = 1, refine_blocks: int = 0,
                 refine_width: int = 32, remat: bool = False, dtype=torch.float32,
                 param_dtype=None, device="cuda"):
        super().__init__()
        if scale not in (1, 2, 4, 8):
            raise ValueError(f"scale must be in (1, 2, 4, 8), got {scale}")
        if downshuffle < 1:
            raise ValueError(f"downshuffle must be >= 1, got {downshuffle}")
        if refine_blocks < 0:
            raise ValueError(f"refine_blocks must be >= 0, got {refine_blocks}")
        if refine_blocks and refine_width < 1:
            raise ValueError(f"refine_width must be >= 1, got {refine_width}")
        self.depth = depth
        self.scale = scale
        self.downshuffle = downshuffle
        self.refine_blocks = refine_blocks
        self.remat = remat
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        f, r = downshuffle, scale * downshuffle
        self.head = ConvBlock(3 * f * f, width, 3, act=_LEAKY, **kw)
        for i in range(depth):
            self.add_module(f"block{i}", FastResBlock(width, add_rate, **kw))
        self.trunk_conv = ConvBlock(width, width, 3, act=None, **kw)
        if refine_blocks:
            self.refine_proj = ConvBlock(width, refine_width * r * r, 3,
                                         act=_LEAKY, **kw)
            for i in range(refine_blocks):
                self.add_module(f"refine{i}",
                                FastResBlock(refine_width, add_rate, **kw))
            self.tail = ConvBlock(refine_width, 3, 3, act="tanh", **kw)
        else:
            self.tail = ConvBlock(width, 3 * r * r, 3, act="tanh", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h_in, w_in = x.shape[1], x.shape[2]
        r = self.scale * self.downshuffle
        x = self.head(downshuffle_front(x.to(self.dtype), self.downshuffle))
        h = x
        for i in range(self.depth):
            h = run_block(getattr(self, f"block{i}"), h, self.remat)
        x = x + self.trunk_conv(h)
        if self.refine_blocks:
            x = self.refine_proj(x)
            if r > 1:
                x = pixel_shuffle(x, r)
            for i in range(self.refine_blocks):
                x = run_block(getattr(self, f"refine{i}"), x, self.remat)
            x = self.tail(x)
        else:  # tanh before the one shuffle: elementwise ops commute with it
            x = self.tail(x)
            if r > 1:
                x = pixel_shuffle(x, r)
        return x[:, :h_in * self.scale, :w_in * self.scale].float()


def FastDenoiser(depth: int = 14, add_rate: float = 0.2, width: int = 128,
                 downshuffle: int = 2, **kw) -> FastSRGenerator:
    """``family="denoise_fast"``: the fast trunk at 1/``downshuffle``
    resolution with x1 output."""
    return FastSRGenerator(depth=depth, add_rate=add_rate, scale=1, width=width,
                           downshuffle=downshuffle, **kw)
