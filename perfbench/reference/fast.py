"""Plain reference of the ``fast`` generator served with an int8 trunk.

The float model (the JAX package's flagship ``fast``):

    normalize -> 3x3 head conv to width, leaky 0.01
      -> depth x [x + add_rate * conv1(leaky(conv0(x)))], 3x3 convs
      -> 3x3 trunk conv, + head output
      -> 3x3 tail conv to 3 * scale^2 channels, tanh, pixel shuffle -> uint8

The configuration serves it with post-training quantization, which this
file works out for itself from the weights and the calibration images:

- the weights are served in bfloat16; every one of the 2 * depth + 1
  trunk convs ("sites") gets per-output-channel symmetric integer weights,
  ``w_q = round(w / s_w)``, ``s_w = max|w| / qmax`` over the channel;
- each site's input gets one static scale ``s_x = max|x| / qmax``, the
  largest magnitude over the calibration images of the bfloat16 forward;
- a site computes ``round(h / s_x)`` clipped to +-qmax, an exact integer
  convolution, then ``acc * s_x * s_w + bias`` (leaky on conv0); the
  residual stream between sites stays float32;
- head and tail run in bfloat16.

``qmax`` is 127 (int8). The control passes ``qmax=7`` (int4). Float32
arithmetic throughout, TF32 off; ``_bf16`` rounds to bfloat16 where the
configuration states bfloat16, so the scales, which are discrete
decisions, come out as the configuration defines them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Cast, conv, fp8_cast, host_apply, leaky, no_tf32, normalize, tanh_to_uint8


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _bf16_scalar(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.bfloat16))


def sites(depth: int) -> List[str]:
    return [f"block{i}.conv{k}" for i in range(depth) for k in (0, 1)] + ["trunk_conv"]


def convs(cfg: dict) -> List[Tuple[str, int, int, int, int]]:
    """Every conv as (name, cin, cout, kernel, resolution factor against the
    input), in forward order."""
    w, s = cfg["width"], cfg["scale"]
    return ([("head", 3, w, 3, 1)] + [(n, w, w, 3, 1) for n in sites(cfg["depth"])]
            + [("tail", w, 3 * s * s, 3, 1)])


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    for name, ci, co, k, _ in convs(cfg):
        shapes[f"{name}.conv.weight"] = (co, ci, k, k)
        shapes[f"{name}.conv.bias"] = (co,)
    return shapes


def served(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights as the configuration serves them: bfloat16 values."""
    return {k: _bf16(v.float()) for k, v in params.items()}


def _conv_bf16(x, w, b, act: bool):
    """A bfloat16 conv: bfloat16 operands, the sum rounded, then the bias
    added and rounded, then leaky 0.01 rounded."""
    y = _bf16(F.conv2d(_bf16(x), w, None, padding=1))
    y = _bf16(y + b.view(1, -1, 1, 1))
    if act:
        y = _bf16(torch.where(y >= 0, y, y * _bf16_scalar(0.01)))
    return y


def _calibration_forward(p, x, cfg, amax: Dict[str, float]) -> None:
    """The bfloat16 float forward, recording max|x| at every site input."""
    rate = _bf16_scalar(cfg["add_rate"])

    def site(name, h, act):
        amax[name] = max(amax.get(name, 0.0), float(h.abs().amax()))
        return _conv_bf16(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], act)

    x = _conv_bf16(_bf16(x), p["head.conv.weight"], p["head.conv.bias"], True)
    h = x
    for i in range(cfg["depth"]):
        t = site(f"block{i}.conv1", site(f"block{i}.conv0", h, True), False)
        h = _bf16(h + _bf16(t * rate))
    site("trunk_conv", h, False)


def quantize(params: Dict[str, torch.Tensor], calib_u8: Iterable[torch.Tensor],
             cfg: dict, qmax: int = 127) -> Dict[str, dict]:
    """Per site: integer weights ``w_q`` (float32 holding integers), the
    input scale's reciprocal ``inv_x`` and the dequantization ``deq`` =
    s_x * s_w, from the served weights and the calibration batches (uint8
    NHWC), as float32 values."""
    p = served(params)
    amax: Dict[str, float] = {}
    with torch.no_grad():
        for b in calib_u8:
            _calibration_forward(p, normalize(b, cfg["mean"], cfg["std"]), cfg, amax)
    q = {}
    for name in sites(cfg["depth"]):
        w = p[f"{name}.conv.weight"]
        s_w = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / qmax
        s_x = max(amax[name], 1e-8) / qmax
        q[name] = {
            "w_q": torch.clamp(torch.round(w / s_w.view(-1, 1, 1, 1)), -qmax, qmax),
            "inv_x": float(np.float32(1.0 / s_x)),
            "deq": (s_x * s_w.double()).float(),
            "bias": p[f"{name}.conv.bias"],
        }
    return q


def forward_float(params: Dict[str, torch.Tensor], x_u8: torch.Tensor, cfg: dict,
                  cast: Cast = None) -> torch.Tensor:
    """The float model in float32, for a configuration served without
    quantization."""
    rate = cfg["add_rate"]

    def c(name, x):
        return conv(x, params[f"{name}.conv.weight"], params[f"{name}.conv.bias"], cast)

    x = leaky(c("head", normalize(x_u8, cfg["mean"], cfg["std"])), 0.01)
    h = x
    for i in range(cfg["depth"]):
        h = h + rate * c(f"block{i}.conv1", leaky(c(f"block{i}.conv0", h), 0.01))
    x = x + c("trunk_conv", h)
    return tanh_to_uint8(F.pixel_shuffle(torch.tanh(c("tail", x)), cfg["scale"]))


def forward(params: Dict[str, torch.Tensor], quant: Dict[str, dict], x_u8: torch.Tensor,
            cfg: dict, qmax: int = 127) -> torch.Tensor:
    """uint8 NHWC -> uint8 NHWC at ``cfg["scale"]`` through the quantized
    trunk (``quant`` from :func:`quantize` with the same ``qmax``)."""
    p = served(params)
    rate = float(np.float32(cfg["add_rate"]))

    def site(name, h, act):
        s = quant[name]
        hq = torch.clamp(torch.round(h * s["inv_x"]), -qmax, qmax)
        acc = F.conv2d(hq, s["w_q"], None, padding=1)
        y = acc * s["deq"].view(1, -1, 1, 1) + s["bias"].view(1, -1, 1, 1)
        return torch.where(y >= 0, y, y * float(np.float32(0.01))) if act else y

    x = normalize(x_u8, cfg["mean"], cfg["std"])
    x = _conv_bf16(x, p["head.conv.weight"], p["head.conv.bias"], True)
    h = x
    for i in range(cfg["depth"]):
        t = site(f"block{i}.conv1", site(f"block{i}.conv0", h, True), False)
        h = h + t * rate
    x = x + site("trunk_conv", h, False)
    y = _bf16(torch.tanh(_conv_bf16(x, p["tail.conv.weight"], p["tail.conv.bias"], False)))
    return tanh_to_uint8(F.pixel_shuffle(y, cfg["scale"]))


def make(params: Dict[str, torch.Tensor], cfg: dict, calibration: Sequence[np.ndarray],
         device, control: bool = False) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 NHWC host batches -> the reference's uint8 outputs. An int8
    configuration is quantized here from ``calibration`` (uint8 NHWC host
    batches); its control quantizes to int4 instead. A float configuration
    runs the float model; its control rounds every conv's operands to
    float8."""
    if cfg["precision"] != "int8":
        cast = fp8_cast if control else None
        return host_apply(lambda x: forward_float(params, x, cfg, cast), device)
    qmax = 7 if control else 127
    with torch.no_grad(), no_tf32():
        quant = quantize(params, [torch.from_numpy(b).to(device) for b in calibration], cfg, qmax)
    return host_apply(lambda x: forward(params, quant, x, cfg, qmax), device)


def conv_precisions(cfg: dict) -> Dict[str, str]:
    """Each conv's serving precision: the trunk sites in int8 when the
    configuration quantizes, the rest in its float type."""
    trunk = set(sites(cfg["depth"])) if cfg["precision"] == "int8" else set()
    return {name: ("int8" if name in trunk else cfg["dtype"]) for name, *_ in convs(cfg)}
