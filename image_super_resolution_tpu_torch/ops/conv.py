"""Core convolution block on NHWC tensors (counterpart of the JAX package's
``ops/conv.py`` in its fused, BN-free form: biased conv -> act).

The block takes and returns NHWC. ``x.permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is an NCHW view in ``channels_last`` memory, so the convolution
runs channels-last with no copy on either side.

Rounding follows flax's ``nn.Conv`` with a compute ``dtype``: the conv
output is rounded to that dtype first, then the bias, cast to the same
dtype, is added (a second rounding). Adding the bias inside the conv would
round once and differ from the JAX package in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..utils.general import autopad
from .activations import ActSpec, apply_act


def conv_bias_nhwc(x: torch.Tensor, weight: torch.Tensor, bias=None, stride=1,
                   padding=0, dilation=1, groups=1) -> torch.Tensor:
    """Conv of an NHWC tensor with an OIHW kernel, returning NHWC: the conv
    in ``x``'s dtype, then ``+ bias.to(dtype)``, as flax computes it."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, padding, dilation,
                 groups).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply an ``nn.Conv2d`` to an NHWC tensor, returning NHWC."""
    return conv_bias_nhwc(x, conv.weight, conv.bias, conv.stride, conv.padding,
                          conv.dilation, conv.groups)


class ConvBlock(nn.Module):
    """conv('same', biased) + act. Parameters: ``conv.weight`` (OIHW) and
    ``conv.bias``, the flax ``conv/kernel`` and ``conv/bias``."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int = 1,
        act: ActSpec = None,
        use_bn: bool = False,
        stride: int = 1,
        dilation: int = 1,
        dtype=torch.float32,
        device="cuda",
    ):
        super().__init__()
        if use_bn:
            raise NotImplementedError(
                "BatchNorm ConvBlocks are ported with training (slice 4); "
                "serving uses the BN-folded (fused) graph"
            )
        pad = autopad(kernel, None, dilation)
        self.act = act
        self.conv = nn.Conv2d(
            in_features, features, kernel, stride=stride, padding=pad,
            dilation=dilation, bias=True, dtype=dtype,
            device=resolve_device(device),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(conv_nhwc(x, self.conv), self.act)


def same_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Stride-1 'same' conv of an NHWC tensor with an OIHW kernel, no bias."""
    pad = weight.shape[-1] // 2
    return F.conv2d(x.permute(0, 3, 1, 2), weight, padding=pad).permute(0, 2, 3, 1)
