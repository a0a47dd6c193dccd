"""NHWC pixel shuffle (depth-to-space) with torch's channel order.

``torch.nn.PixelShuffle`` on NCHW maps channel ``c*r^2 + i*r + j`` to output
offset (i, j) of channel c; these functions do the same on NHWC tensors.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, H, W, C*r*r) -> (N, H*r, W*r, C) with torch channel ordering."""
    n, h, w, c = x.shape
    r = scale
    if c % (r * r) != 0:
        raise ValueError(f"channels {c} not divisible by scale^2={r * r}")
    oc = c // (r * r)
    x = x.reshape(n, h, w, oc, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # n, h, r_h, w, r_w, oc
    return x.reshape(n, h * r, w * r, oc)


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Inverse: (N, H*r, W*r, C) -> (N, H, W, C*r*r)."""
    n, hr, wr, c = x.shape
    r = scale
    if hr % r or wr % r:
        raise ValueError(f"spatial dims {(hr, wr)} not divisible by {r}")
    h, w = hr // r, wr // r
    x = x.reshape(n, h, r, w, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # n, h, w, c, r_h, r_w
    return x.reshape(n, h, w, c * r * r)
