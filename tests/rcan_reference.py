"""Plain float32 RCAN written as its source writes it (Zhang et al., ECCV
2018; ``RCAN_TrainCode/code/model/rcan.py`` and ``common.py``): NCHW
``nn.Module``s whose state-dict names are the source's (``sub_mean``,
``head.0``, ``body.{g}.body.{b}.body.{0,2}``, ``...body.3.conv_du.{0,2}``,
``body.{g}.body.{blocks}``, ``body.{groups}``, ``tail.0.{0,2}``,
``tail.1``, ``add_mean``), the layout of its published checkpoints.
``res_scale`` 1, no batch norm, no activation in the upsampler. Imports
nothing of the port.

``upscale(model, x_u8)``: uint8 NHWC -> uint8 NHWC, ``round(clamp(y, 0,
255))`` as the source's ``quantize`` at ``rgb_range`` 255.
``ca_residual(x, r, layer)``: one block's ``x + CA(r) * r``.
"""

import numpy as np
import torch
from torch import nn

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=True)


class MeanShift(nn.Conv2d):
    def __init__(self, rgb_range, rgb_mean, sign=-1):
        super().__init__(3, 3, kernel_size=1)
        self.weight.data = torch.eye(3).view(3, 3, 1, 1)
        self.bias.data = sign * rgb_range * torch.tensor(rgb_mean)
        self.requires_grad_(False)


class CALayer(nn.Module):
    def __init__(self, channel: int, reduction: int):
        super().__init__()
        self.avg_pool = nn.AdaptiveAvgPool2d(1)
        self.conv_du = nn.Sequential(conv(channel, channel // reduction, 1), nn.ReLU(),
                                     conv(channel // reduction, channel, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.conv_du(self.avg_pool(x))


class RCAB(nn.Module):
    def __init__(self, n_feat: int, reduction: int):
        super().__init__()
        self.body = nn.Sequential(conv(n_feat, n_feat, 3), nn.ReLU(), conv(n_feat, n_feat, 3),
                                  CALayer(n_feat, reduction))

    def forward(self, x):
        return self.body(x) + x


class ResidualGroup(nn.Module):
    def __init__(self, n_feat: int, reduction: int, n_resblocks: int):
        super().__init__()
        self.body = nn.Sequential(*[RCAB(n_feat, reduction) for _ in range(n_resblocks)],
                                  conv(n_feat, n_feat, 3))

    def forward(self, x):
        return self.body(x) + x


class Upsampler(nn.Sequential):
    def __init__(self, scale: int, n_feat: int):
        m = []
        for _ in range(scale.bit_length() - 1):
            m += [conv(n_feat, 4 * n_feat, 3), nn.PixelShuffle(2)]
        super().__init__(*m)


class RCAN(nn.Module):
    def __init__(self, n_resgroups=10, n_resblocks=20, n_feats=64, reduction=16, scale=4,
                 rgb_range=255, rgb_mean=RGB_MEAN):
        super().__init__()
        self.sub_mean = MeanShift(rgb_range, rgb_mean, -1)
        self.head = nn.Sequential(conv(3, n_feats, 3))
        self.body = nn.Sequential(*[ResidualGroup(n_feats, reduction, n_resblocks)
                                    for _ in range(n_resgroups)], conv(n_feats, n_feats, 3))
        self.tail = nn.Sequential(Upsampler(scale, n_feats), conv(n_feats, 3, 3))
        self.add_mean = MeanShift(rgb_range, rgb_mean, 1)

    def forward(self, x):
        x = self.head(self.sub_mean(x))
        res = self.body(x) + x
        return self.add_mean(self.tail(res))


def upscale(model: RCAN, x_u8: np.ndarray) -> np.ndarray:
    """uint8 NHWC -> uint8 NHWC in float32."""
    with torch.no_grad():
        y = model(torch.from_numpy(np.ascontiguousarray(x_u8)).permute(0, 3, 1, 2).float())
    return torch.round(torch.clamp(y, 0, 255)).to(torch.uint8).permute(0, 2, 3, 1).numpy()


def ca_residual(x: torch.Tensor, r: torch.Tensor, layer: CALayer) -> torch.Tensor:
    """NCHW: ``x + CA(r) * r``, the end of one RCAB."""
    with torch.no_grad():
        return layer(r) + x
