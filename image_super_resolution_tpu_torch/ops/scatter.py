"""Scatter-form residual dense block (counterpart of the JAX package's
``ops/scatter.py``).

The standard RDB computes each growth conv over a dense concatenation,
``y_i = act(W_i @ [x, y_0..y_{i-1}])``. The scatter form regroups the same
arithmetic by source: one wide conv per available tensor computes its
contributions to every later consumer (y_0..y_3 and the fusion conv):

    from x  : 64 -> 192   (y0|y1|y2|y3|fuse slices)
    from y0 : 32 -> 160   (y1|y2|y3|fuse)
    from y1 : 32 -> 128   (y2|y3|fuse)
    from y2 : 32 ->  96   (y3|fuse)
    from y3 : 32 ->  64   (fuse)

``ScatterRDB`` holds the five kernels in the (9*Cin, Cout) matmul form that
the fused kernel takes (``ops/kernels/fused_rdb.py``), so the layout
transform runs once, when the weights are loaded. With ``wino_m`` 2 or 4 it
holds them in the Winograd domain instead and runs its five convs through
``ops/winograd.py``, as the JAX module does.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from .activations import apply_act, dtype_scalar
from .kernels.fused_rdb import scatter_rdb
from .winograd import transform_kernel, winograd_conv3x3


class ScatterRDB(nn.Module):
    """Inference-only scatter-form RDB on NHWC tensors.

    Parameters ``sx``, ``s0``..``s3``: (9*Cin, Cout) matmul-form kernels in
    the compute dtype; ``bias``: (1, 4g+C), always fp32 (the kernel adds it
    to fp32 sums). A CUDA tensor goes through the hand-written kernel, a CPU
    tensor through its plain PyTorch version (``scatter_rdb``).

    ``wino_m`` 2 or 4 is the caller's choice of another form of the convs,
    the JAX module's Winograd F(wino_m, 3): the kernels are then
    (t*t*Cin, Cout) flattenings of Winograd-domain (t, t, Cin, Cout)
    kernels (t = wino_m + 2, from ``rdb_params_to_scatter(wino_m=...)``),
    and the five convs run through ``ops/winograd.winograd_conv3x3`` on any
    device, with the JAX graph's numerics: each conv's output, each ``y_i``
    and each sum of slices rounded to the compute dtype. It is not a
    fallback: the fused kernel is not launched on this path.
    """

    def __init__(self, features: int = 64, act=("leaky_relu", 0.01),
                 add_rate: float = 0.2, wino_m: int = 0,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        if not isinstance(act, tuple) or act[0] != "leaky_relu":
            raise ValueError(f"ScatterRDB computes leaky_relu only, got {act!r}")
        if wino_m not in (0, 2, 4):
            raise ValueError(f"wino_m must be 0, 2 or 4, got {wino_m}")
        self.act = act
        self.slope = float(act[1])
        self.add_rate = add_rate
        self.wino_m = wino_m
        self.dtype = dtype
        c, g = features, features // 2
        taps = (wino_m + 2) ** 2 if wino_m else 9
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        shapes = {"sx": (c, 4 * g + c), "s0": (g, 3 * g + c),
                  "s1": (g, 2 * g + c), "s2": (g, g + c), "s3": (g, c)}
        for name, (cin, cout) in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(taps * cin, cout, **kw),
                                   requires_grad=False))
        self.bias = nn.Parameter(
            torch.zeros(1, 4 * g + c, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.wino_m:
            return self._winograd(x)
        return scatter_rdb(x.contiguous(), self.sx, self.s0, self.s1, self.s2,
                           self.s3, self.bias, self.add_rate, self.slope)

    def _winograd(self, x: torch.Tensor) -> torch.Tensor:
        g = x.shape[-1] // 2
        act = lambda v: apply_act(v, self.act)  # noqa: E731
        conv = lambda v, k, b=None: winograd_conv3x3(  # noqa: E731
            v, k, b, m=self.wino_m, dtype=self.dtype)
        cx = conv(x, self.sx, self.bias)
        y0 = act(cx[..., :g])
        c0 = conv(y0, self.s0)
        y1 = act(cx[..., g:2 * g] + c0[..., :g])
        c1 = conv(y1, self.s1)
        y2 = act(cx[..., 2 * g:3 * g] + c0[..., g:2 * g] + c1[..., :g])
        c2 = conv(y2, self.s2)
        y3 = act(cx[..., 3 * g:4 * g] + c0[..., 2 * g:3 * g] + c1[..., g:2 * g]
                 + c2[..., :g])
        c3 = conv(y3, self.s3)
        fuse = cx[..., 4 * g:] + c0[..., 3 * g:] + c1[..., 2 * g:] + c2[..., g:] + c3
        return fuse * dtype_scalar(self.add_rate, x.dtype) + x


def rdb_params_to_scatter(rdb: Dict[str, Any], wino_m: int = 0) -> Dict[str, Any]:
    """Fused standard-RDB params (flax tree of numpy arrays, HWIO kernels)
    -> ScatterRDB params (HWIO kernels ``sx``..``s3`` + ``bias``; with
    ``wino_m`` 2 or 4 the kernels in the Winograd domain, (t, t, Cin, Cout)
    fp32, from ``ops/winograd.transform_kernel``).

    Dense concat order is [x, y0, y1, y2, y3], so kernel input rows slice by
    source: x rows [0:c], y_j rows [c+j*g : c+(j+1)*g].
    """
    k = [np.asarray(rdb[f"conv{i}"]["conv"]["kernel"]) for i in range(4)]
    b = [np.asarray(rdb[f"conv{i}"]["conv"]["bias"]) for i in range(4)]
    kf = np.asarray(rdb["conv_fuse"]["conv"]["kernel"])
    bf = np.asarray(rdb["conv_fuse"]["conv"]["bias"])
    c = k[0].shape[2]
    g = k[0].shape[3]

    def rows(kernel, src):  # src: -1 for x, j for y_j
        if src < 0:
            return kernel[:, :, :c, :]
        lo = c + src * g
        return kernel[:, :, lo:lo + g, :]

    cat = lambda parts: np.concatenate(parts, axis=3)
    out = {
        "sx": cat([rows(k[0], -1), rows(k[1], -1), rows(k[2], -1),
                   rows(k[3], -1), rows(kf, -1)]),
        "s0": cat([rows(k[1], 0), rows(k[2], 0), rows(k[3], 0), rows(kf, 0)]),
        "s1": cat([rows(k[2], 1), rows(k[3], 1), rows(kf, 1)]),
        "s2": cat([rows(k[3], 2), rows(kf, 2)]),
        "s3": rows(kf, 3),
        "bias": np.concatenate([b[0], b[1], b[2], b[3], bf]),
    }
    if wino_m:
        out = {name: v if name == "bias" else transform_kernel(v, wino_m).numpy()
               for name, v in out.items()}
    return out
