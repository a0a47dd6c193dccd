"""Plain float32 reference of RCAN, the residual channel attention network
(Zhang et al., ECCV 2018, arXiv:1807.02758; github.com/yulunzhang/RCAN,
``RCAN_TrainCode/code/model/rcan.py``):

    x0 = head(x - rgb_range * mean)                       3x3 conv 3 -> C
    RCAB(x) = x + CA(r) * r,  r = conv(relu(conv(x)))     both 3x3 C -> C, biased
    CA(r) = sigmoid(W2 relu(W1 GAP(r) + b1) + b2)         GAP over each whole image;
                                                          1x1 convs C -> C/reduction -> C
    group(x) = x + conv(RCAB^blocks(x))                   3x3 C -> C
    body = trunk_conv(group^depth(x0)) + x0               3x3 C -> C
    y = tail(log2(scale) x [3x3 conv C -> 4C, pixel shuffle 2](body)) + rgb_range * mean
    out = round(clamp(y, 0, 255))                         ties to even

``depth`` counts the residual groups (the source's n_resgroups), ``blocks``
the RCABs in each (n_resblocks). No kernel, no fusion, no stream in another
precision. ``convs`` lists the 3x3 convs only: the channel attention's two
1x1 convs run once per image (about a kFLOP), not per pixel. Parameter
names are the port's state-dict names, so one seeded set of weights serves
both sides.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Cast, conv, fp8_cast, host_apply


def convs(cfg: dict) -> List[Tuple[str, int, int, int, int]]:
    """Every 3x3 conv as (name, cin, cout, kernel, resolution factor against
    the input), in forward order."""
    w = cfg["width"]
    out = [("head", 3, w, 3, 1)]
    for g in range(cfg["depth"]):
        for b in range(cfg["blocks"]):
            out += [(f"group{g}.block{b}.conv{k}", w, w, 3, 1) for k in (0, 1)]
        out.append((f"group{g}.conv", w, w, 3, 1))
    out.append(("trunk_conv", w, w, 3, 1))
    n_up = cfg["scale"].bit_length() - 1
    out += [(f"up{u}", w, 4 * w, 3, 2 ** u) for u in range(n_up)]
    out.append(("tail", w, 3, 3, cfg["scale"]))
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """State-dict name -> shape (OIHW kernels, then biases); the 3x3 convs'
    and each block's two 1x1 channel-attention convs."""
    w, hidden = cfg["width"], cfg["width"] // cfg["reduction"]
    layers = [(name, ci, co, k) for name, ci, co, k, _ in convs(cfg)]
    for g in range(cfg["depth"]):
        for b in range(cfg["blocks"]):
            p = f"group{g}.block{b}"
            layers += [(f"{p}.ca_down", w, hidden, 1), (f"{p}.ca_up", hidden, w, 1)]
    shapes = {}
    for name, ci, co, k in layers:
        shapes[f"{name}.conv.weight"] = (co, ci, k, k)
        shapes[f"{name}.conv.bias"] = (co,)
    return shapes


def forward(params: Dict[str, torch.Tensor], x_u8: torch.Tensor, cfg: dict,
            cast: Cast = None) -> torch.Tensor:
    """uint8 NHWC -> uint8 NHWC at ``cfg["scale"]``, in float32."""
    def c(name, x):
        return conv(x, params[f"{name}.conv.weight"], params[f"{name}.conv.bias"], cast)

    def ca(name, r):
        w1, b1 = params[f"{name}.ca_down.conv.weight"], params[f"{name}.ca_down.conv.bias"]
        w2, b2 = params[f"{name}.ca_up.conv.weight"], params[f"{name}.ca_up.conv.bias"]
        m = r.mean((2, 3))
        h = torch.relu(m @ w1[:, :, 0, 0].t() + b1)
        return torch.sigmoid(h @ w2[:, :, 0, 0].t() + b2)[:, :, None, None]

    shift = cfg["rgb_range"] * torch.tensor(cfg["mean"], dtype=torch.float32,
                                            device=x_u8.device).view(1, 3, 1, 1)
    x0 = c("head", x_u8.permute(0, 3, 1, 2).float() - shift)
    h = x0
    for g in range(cfg["depth"]):
        s = h
        for b in range(cfg["blocks"]):
            p = f"group{g}.block{b}"
            r = c(f"{p}.conv1", torch.relu(c(f"{p}.conv0", s)))
            s = s + ca(p, r) * r
        h = h + c(f"group{g}.conv", s)
    x = c("trunk_conv", h) + x0
    for u in range(cfg["scale"].bit_length() - 1):
        x = F.pixel_shuffle(c(f"up{u}", x), 2)
    y = torch.round(torch.clamp(c("tail", x) + shift, 0.0, 255.0))
    return y.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def make(params: Dict[str, torch.Tensor], cfg: dict, calibration: Sequence[np.ndarray],
         device, control: bool = False) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 NHWC host batches -> the reference's uint8 outputs. The
    control (``control=True``) rounds every 3x3 conv's operands to float8:
    the precision below the configuration's bfloat16."""
    cast = fp8_cast if control else None
    return host_apply(lambda x: forward(params, x, cfg, cast), device)


def conv_precisions(cfg: dict) -> Dict[str, str]:
    """Each conv's serving precision: all of them in the configuration's."""
    return {name: cfg["precision"] for name, *_ in convs(cfg)}
