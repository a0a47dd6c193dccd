"""SRGAN discriminator (counterpart of the JAX package's
``models/discriminator.py``).

Eight conv blocks, leaky 0.2, the first without BN: even blocks grow the
channels at stride 1 (64, then twice the input), odd blocks keep them at
stride 2. Then ``adaptive_avg_pool`` to 6x6, ``fc1`` (36 * 512 -> 1024,
leaky 0.2) and ``fc2`` (-> 1 logit, fp32). 23,563,649 parameters at the
defaults.

NHWC throughout: the map is flattened as H*W*C before ``fc1``, as the JAX
package flattens it, so an ``fc1`` kernel carried over from JAX computes the
same function (an NCHW flatten would need its rows permuted).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import ConvBlock, DenseBlock

_ACT = ("leaky_relu", 0.2)


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` on NHWC: bin i covers rows
    [floor(i*H/out), ceil((i+1)*H/out)). The identity when the map is
    already out_h x out_w (a 96-pixel patch)."""
    if x.shape[1:3] == (out_h, out_w):
        return x
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (out_h, out_w))
    return y.permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """Real/fake logit per image; NHWC normalized images in, (N, 1) fp32 out.
    Module names follow flax's: ``block{i}``, ``fc1``, ``fc2``."""

    def __init__(self, kernel: int = 3, channels: int = 64, n_blocks: int = 8,
                 fc_size: int = 1024, dtype=torch.bfloat16, param_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.n_blocks = n_blocks
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        in_ch = 3
        for i in range(n_blocks):
            out_ch = (channels if i == 0 else in_ch * 2) if i % 2 == 0 else in_ch
            self.add_module(f"block{i}", ConvBlock(
                in_ch, out_ch, kernel, act=_ACT, use_bn=i != 0,
                stride=1 if i % 2 == 0 else 2, **kw))
            in_ch = out_ch
        self.fc1 = DenseBlock(in_ch * 36, fc_size, act=_ACT, **kw)
        self.fc2 = DenseBlock(fc_size, 1, act=None, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        x = adaptive_avg_pool(x, 6, 6)
        x = x.reshape(x.shape[0], -1)  # NHWC order: H*W*C
        return self.fc2(self.fc1(x)).float()
