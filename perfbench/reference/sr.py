"""Plain float32 reference of the ``sr`` generator: the ESRGAN-style RRDB
net of thnak/image_super_resolution (``utils/models.py``, ``ResNet``), in
its BN-folded serving form.

    normalize -> 9x9 head conv, leaky 0.2
      -> depth x RRDB (3 x RDB: four growth convs 3x3 with dense concat and
         leaky 0.01, a 3x3 fusion conv, ``x + add_rate * fuse``; then
         ``x + add_rate * h`` around the three)
      -> 3x3 trunk conv, + head output
      -> log2(scale) x [3x3 conv to 4 * width, pixel shuffle x2, leaky 0.01]
      -> 9x9 tail conv to 3 channels, tanh -> uint8

No rewrite of any kind: no scatter form, no folded tail, no fused kernel.
Parameter names are the serving graph's state-dict names, so one seeded
set of weights can be handed to both sides.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Cast, conv, fp8_cast, host_apply, leaky, normalize, tanh_to_uint8


def _rdb_convs(width: int) -> List[Tuple[str, int, int, int]]:
    g = width // 2
    convs = [(f"conv{k}", width + k * g, g, 3) for k in range(4)]
    return convs + [("conv_fuse", width + 4 * g, width, 3)]


def convs(cfg: dict) -> List[Tuple[str, int, int, int, int]]:
    """Every conv as (name, cin, cout, kernel, resolution factor against the
    input), in forward order."""
    w, hk, tk = cfg["width"], cfg["head_kernel"], cfg["tail_kernel"]
    out = [("head", 3, w, hk, 1)]
    for i in range(cfg["depth"]):
        for j in range(3):
            out += [(f"rrdb{i}.rdb{j}.{n}", ci, co, k, 1)
                    for n, ci, co, k in _rdb_convs(w)]
    out.append(("trunk_conv", w, w, 3, 1))
    n_up = cfg["scale"].bit_length() - 1
    out += [(f"up{u}.conv", w, 4 * w, 3, 2 ** u) for u in range(n_up)]
    out.append(("tail", w, 3, tk, cfg["scale"]))
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """State-dict name -> shape (OIHW kernels, then biases)."""
    shapes = {}
    for name, ci, co, k, _ in convs(cfg):
        shapes[f"{name}.conv.weight"] = (co, ci, k, k)
        shapes[f"{name}.conv.bias"] = (co,)
    return shapes


def forward(params: Dict[str, torch.Tensor], x_u8: torch.Tensor, cfg: dict,
            cast: Cast = None) -> torch.Tensor:
    """uint8 NHWC -> uint8 NHWC at ``cfg["scale"]``, in float32."""
    rate, slope = cfg["add_rate"], cfg["slope"]

    def c(name, x):
        return conv(x, params[f"{name}.conv.weight"], params[f"{name}.conv.bias"], cast)

    x = leaky(c("head", normalize(x_u8, cfg["mean"], cfg["std"])), cfg["head_slope"])
    h = x
    for i in range(cfg["depth"]):
        r = h
        for j in range(3):
            p = f"rrdb{i}.rdb{j}"
            feats = [r]
            for k in range(4):
                feats.append(leaky(c(f"{p}.conv{k}", torch.cat(feats, 1)), slope))
            r = r + rate * c(f"{p}.conv_fuse", torch.cat(feats, 1))
        h = h + rate * r
    x = x + c("trunk_conv", h)
    for u in range(cfg["scale"].bit_length() - 1):
        x = leaky(F.pixel_shuffle(c(f"up{u}.conv", x), 2), slope)
    return tanh_to_uint8(torch.tanh(c("tail", x)))


def make(params: Dict[str, torch.Tensor], cfg: dict, calibration: Sequence[np.ndarray],
         device, control: bool = False) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 NHWC host batches -> the reference's uint8 outputs. The
    control (``control=True``) rounds every conv's operands to float8: the
    precision below the configuration's bfloat16."""
    cast = fp8_cast if control else None
    return host_apply(lambda x: forward(params, x, cfg, cast), device)


def conv_precisions(cfg: dict) -> Dict[str, str]:
    """Each conv's serving precision: all of them in the configuration's."""
    return {name: cfg["precision"] for name, *_ in convs(cfg)}
