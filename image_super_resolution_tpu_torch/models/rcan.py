"""RCAN, the residual channel attention network (Zhang et al., ECCV 2018,
arXiv:1807.02758; ``RCAN_TrainCode/code/model/rcan.py``), as the port
serves it. The JAX package has no counterpart.

    x0 = head(x - 255 mean)                          3x3 conv 3 -> C
    RCAB(x) = x + (r + b) * CA(r + b),  r = conv1(relu(conv0(x))), b conv1's bias
    CA(y) = sigmoid(W2 relu(W1 GAP(y) + b1) + b2)    GAP over each whole image;
                                                     1x1 convs C -> C/reduction -> C
    group(x) = x + conv(RCAB^blocks(x))
    body = trunk_conv(group^groups(x0)) + x0
    y = tail(log2(scale) x [3x3 conv C -> 4C, pixel shuffle 2](body))
    out = round(clamp(y + 255 mean, 0, 255))         ``rgb255_to_uint8``

The input map ``x - 255 mean`` is ``normalize`` with std 1/255
(``RCAN_STD``); no residual is scaled. NHWC, module names in the flax
style of the port's other generators (``head``, ``group{g}/block{b}/
{conv0,conv1,ca_down,ca_up}``, ``group{g}/conv``, ``trunk_conv``,
``up{u}``, ``tail``), so an ``.isr`` tree loads by name.

Precision: the 3x3 convs in the compute dtype (bf16 on the card, cuDNN,
fp32 sums; conv0 as cuDNN's fused conv-bias-ReLU); the GAP, the CA MLP and
conv1's bias in fp32; the residual stream (each block's running sum, each
group's skip, the long skip) in the compute dtype too. At published widths
on seeded weights a bf16 stream reads 0.69-0.76 LSB RMS against the
float32 reference, an fp32 one 0.51-0.56, and bf16 moves half the bytes
(PERF.md, section 4). A block ends in K3 (``ops/kernels/
channel_attention``): the GAP, the MLP and ``x + (r + b) * s`` in two
launches. Each group is the span ``rcan/group``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.transforms import rgb255_to_uint8
from ..ops.conv import ConvBlock, conv_bias_nhwc, conv_relu
from ..ops.kernels.channel_attention import ca_residual
from ..ops.pixel_shuffle import pixel_shuffle
from ..utils.profiling import annotate

RCAN_MEAN = (0.4488, 0.4371, 0.4040)  # the source's rgb_mean, at rgb_range 255
RCAN_STD = (1.0 / 255.0,) * 3  # normalize's (x / 255 - mean) / std is x - 255 mean


class RCAB(nn.Module):
    """conv0 (3x3, ReLU) -> conv1 (3x3) -> channel attention -> + x. The CA's
    1x1 convs (``ca_down``, ``ca_up``) and conv1's bias are fp32."""

    def __init__(self, width: int, reduction: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.conv0 = ConvBlock(width, width, 3, act="relu", **kw)
        self.conv1 = ConvBlock(width, width, 3, **kw)
        self.conv1.conv.bias.data = self.conv1.conv.bias.data.float()
        f32 = dict(dtype=torch.float32, device=device)
        self.ca_down = ConvBlock(width, width // reduction, 1, **f32)
        self.ca_up = ConvBlock(width // reduction, width, 1, **f32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = conv_bias_nhwc(conv_relu(x, self.conv0.conv), self.conv1.conv.weight, padding=1)
        w1, w2 = self.ca_down.conv.weight, self.ca_up.conv.weight
        return ca_residual(x, r, self.conv1.conv.bias, w1.view(w1.shape[:2]),
                           self.ca_down.conv.bias, w2.view(w2.shape[:2]), self.ca_up.conv.bias)


class ResidualGroup(nn.Module):
    def __init__(self, blocks: int, width: int, reduction: int, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.blocks = blocks
        for b in range(blocks):
            self.add_module(f"block{b}", RCAB(width, reduction, dtype, device))
        self.conv = ConvBlock(width, width, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for b in range(self.blocks):
            h = getattr(self, f"block{b}")(h)
        return x + self.conv(h)


class RCAN(nn.Module):
    """NHWC in (``x - 255 mean``), the compute dtype's NHWC ``y`` out (before
    ``+ 255 mean``).

    What the serving code reads of it (``models/deploy``, ``infer/engine``):
    ``to_uint8``, its output map; ``global_pool``, a block's output depends
    on the whole image (the channel attention's average), so an image cannot
    be cut into bands served apart."""

    global_pool = True

    def __init__(self, groups: int = 10, blocks: int = 20, width: int = 64,
                 reduction: int = 16, scale: int = 4, dtype=torch.float32, device="cuda"):
        super().__init__()
        if scale not in (2, 4, 8):
            raise ValueError(f"scale must be in (2, 4, 8), got {scale}")
        if width % reduction:
            raise ValueError(f"width {width} must be a multiple of reduction {reduction}")
        self.groups = groups
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.head = ConvBlock(3, width, 3, **kw)
        for g in range(groups):
            self.add_module(f"group{g}", ResidualGroup(blocks, width, reduction, **kw))
        self.trunk_conv = ConvBlock(width, width, 3, **kw)
        self.n_up = scale.bit_length() - 1
        for u in range(self.n_up):
            self.add_module(f"up{u}", ConvBlock(width, 4 * width, 3, **kw))
        self.tail = ConvBlock(width, 3, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = h = self.head(x.to(self.dtype))
        for g in range(self.groups):
            with annotate("rcan/group"):
                h = getattr(self, f"group{g}")(h)
        y = x0 + self.trunk_conv(h)
        for u in range(self.n_up):
            y = pixel_shuffle(getattr(self, f"up{u}")(y), 2)
        return self.tail(y)

    @staticmethod
    def to_uint8(y: torch.Tensor, mean) -> torch.Tensor:
        return rgb255_to_uint8(y, mean)
