"""Plain float32 reference of BasicVSR x4 (Chan et al., CVPR 2021,
arXiv:2012.02181; github.com/XPixelGroup/BasicSR, ``basicsr/archs/
basicvsr_arch.py``, ``spynet_arch.py``, ``arch_util.py``), on one segment
of T frames (uint8 (T, H, W, 3) -> uint8 (T, 4H, 4W, 3)), x in [0, 1]:

    flows_b = spynet(x[:-1], x[1:]),  flows_f = spynet(x[1:], x[:-1])
    back_i = trunk_b(cat[x_i, warp(back_{i+1}, flows_b[i])])   i = T-1 .. 0, zero state first
    fwd_i  = trunk_f(cat[x_i, warp(fwd_{i-1}, flows_f[i-1])])  i = 0 .. T-1, zero state first
    trunk(z) = block^30(lrelu(conv_in(z))),  block(h) = h + conv1(relu(conv0(h)))
    y_i = conv_last(lrelu(conv_hr(up(up(lrelu(fusion(cat[back_i, fwd_i])))))))
          + bilinear_x4(x_i),   up(z) = lrelu(pixel_shuffle(conv(z), 2))
    (up: width -> 4 width, then width -> 256; conv_hr 64 -> 64, conv_last 64 -> 3)
    out = round(clamp(255 y, 0, 255))                          ties to even

``warp`` is ``F.grid_sample`` (bilinear, align_corners True) over the pixel
mesh plus the flow, zero padding; SPyNet's warps pad by the border. SPyNet
(``spynet``): bilinear resize (align_corners False) to multiples of 32,
ImageNet normalisation, a 6-level average-pool pyramid, then from the
coarsest level up ``flow = level_l(cat[ref, warp(supp, up), up]) + up``
with ``up`` the flow doubled (bilinear, align_corners True, times 2) and
replicate-padded by a row or column where the sizes differ; the flow is
resized back (bilinear, align_corners False) and scaled by w/w_up, h/h_up.
Each level is five 7x7 convs 8 -> 32 -> 64 -> 32 -> 16 -> 2 with a ReLU
between. lrelu's slope is 0.1. The directions run one after the other, as
the source runs them; no kernel of the port, no fused buffer. Parameter
names are the port's state-dict names, so one seeded set of weights serves
both sides.

The same code computes the model in a lower precision (``forward``'s
``q``), float32 arithmetic with the tensors rounded where the port rounds
them: the weights; every tensor a conv reads (SPyNet's level input, the
frame and the warped state of a trunk input); each conv's sum, then its
sum plus the bias, but once for a fused conv-bias-ReLU (SPyNet's first
four, each block's conv0); each leaky ReLU and residual sum. Flows and
sampling stay float32. With seeded weights the recurrence amplifies
rounding by a factor that varies with the seed, so the ``clips`` kind
holds the program's difference from float32 against the bfloat16 model's
(``make``'s ``rounded``), frame by frame.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import fp8_cast, host_apply

LEVELS = 6
SPYNET = (8, 32, 64, 32, 16, 2)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HR = 64  # the source's fixed width from the second upsampler on (num_feat elsewhere)


def convs(cfg: dict) -> List[Tuple[str, int, int, int, float]]:
    """Every conv as (name, cin, cout, kernel, resolution factor), each
    counting ``res^2`` output positions per input pixel of a frame.

    The trunks and the reconstruction run once a frame, at the frame's
    resolution (1), 2 and 4 (the two upsamplers, conv_hr, conv_last).
    SPyNet runs on pairs at the working size (``frame_size`` rounded up to
    multiples of 32), level l (0 the coarsest) at 1/2^(levels-1-l) of it,
    in both directions, over T - 1 pairs for T frames. So a SPyNet conv at
    level l does ``2 (T - 1) / T * (Hu Wu) / (H W) / 4^(levels-1-l)`` of its
    work per input pixel, and its ``res`` is the square root of that."""
    w, n = cfg["width"], cfg["blocks"]
    out = []
    t, (h, wd) = cfg["segment"], cfg["frame_size"]
    area = (32 * math.ceil(h / 32)) * (32 * math.ceil(wd / 32)) / (h * wd)
    for level in range(LEVELS):
        res = math.sqrt(2 * (t - 1) / t * area / 4 ** (LEVELS - 1 - level))
        out += [(f"spynet.level{level}.conv{k}", ci, co, 7, res)
                for k, (ci, co) in enumerate(zip(SPYNET, SPYNET[1:]))]
    for branch in ("backward_trunk", "forward_trunk"):
        out.append((f"{branch}.conv_in", 3 + w, w, 3, 1))
        for b in range(n):
            out += [(f"{branch}.block{b}.conv{k}", w, w, 3, 1) for k in (0, 1)]
    out += [("fusion", 2 * w, w, 1, 1), ("up0", w, 4 * w, 3, 1), ("up1", w, 4 * HR, 3, 2),
            ("conv_hr", HR, HR, 3, 4), ("conv_last", HR, 3, 3, 4)]
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """State-dict name -> shape (OIHW kernels, then biases)."""
    shapes = {}
    for name, ci, co, k, _ in convs(cfg):
        shapes[f"{name}.conv.weight"] = (co, ci, k, k)
        shapes[f"{name}.conv.bias"] = (co,)
    return shapes


def warp(x: torch.Tensor, flow: torch.Tensor, padding: str = "zeros") -> torch.Tensor:
    """BasicSR's ``flow_warp``: NCHW ``x`` sampled at the mesh plus ``flow``
    (N, H, W, 2), bilinear, align_corners True."""
    _, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=x.dtype, device=x.device),
                            torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
    v = torch.stack((gx, gy), 2) + flow
    grid = torch.stack((2.0 * v[..., 0] / max(w - 1, 1) - 1.0,
                        2.0 * v[..., 1] / max(h - 1, 1) - 1.0), dim=3)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode=padding, align_corners=True)


Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, back in float32."""
    return t.to(torch.bfloat16).float()


def _conv(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor, q: Round,
          relu: bool = False) -> torch.Tensor:
    """'same' conv of ``q``-valued operands, float32 sums. With ``q`` the
    precision the model is served in: the sum rounded, then the bias added
    and rounded; with ``relu`` (a fused conv-bias-ReLU) the sum plus the
    bias rounded once. ``q`` None: plain float32."""
    y = F.conv2d(z, w, None if q else b, padding=w.shape[-1] // 2)
    if q is None:
        return torch.relu(y) if relu else y
    b = b.view(1, -1, 1, 1)
    return q(torch.relu(y + b)) if relu else q(q(y) + b)


def _lrelu(z: torch.Tensor, q: Round) -> torch.Tensor:
    z = F.leaky_relu(z, 0.1)
    return q(z) if q else z


def spynet(params, ref: torch.Tensor, supp: torch.Tensor, q: Round = None) -> torch.Tensor:
    """Flow from ``ref`` to ``supp`` (NCHW in [0, 1]) -> (N, 2, H, W), the
    flow float32 at every precision; each level's input rounded by ``q``."""
    def level(l, z):
        z = q(z) if q else z
        for k in range(len(SPYNET) - 1):
            p = f"spynet.level{l}.conv{k}.conv"
            z = _conv(z, params[f"{p}.weight"], params[f"{p}.bias"], q, k < len(SPYNET) - 2)
        return z

    h, w = ref.shape[2:]
    hu, wu = 32 * math.ceil(h / 32), 32 * math.ceil(w / 32)
    mean = torch.tensor(IMAGENET_MEAN, device=ref.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=ref.device).view(1, 3, 1, 1)
    refs, supps = [], []
    for images, pyramid in ((ref, refs), (supp, supps)):
        x = F.interpolate(images, size=(hu, wu), mode="bilinear", align_corners=False)
        pyramid.append((x - mean) / std)
        for _ in range(LEVELS - 1):
            pyramid.insert(0, F.avg_pool2d(pyramid[0], 2, 2, count_include_pad=False))
    flow = refs[0].new_zeros(ref.shape[0], 2, refs[0].shape[2] // 2, refs[0].shape[3] // 2)
    for l in range(LEVELS):
        up = F.interpolate(flow, scale_factor=2, mode="bilinear", align_corners=True) * 2.0
        if up.shape[2] != refs[l].shape[2]:
            up = F.pad(up, [0, 0, 0, 1], mode="replicate")
        if up.shape[3] != refs[l].shape[3]:
            up = F.pad(up, [0, 1, 0, 0], mode="replicate")
        warped = warp(supps[l], up.permute(0, 2, 3, 1), "border")
        flow = level(l, torch.cat([refs[l], warped, up], 1)) + up
    flow = F.interpolate(flow, size=(h, w), mode="bilinear", align_corners=False)
    flow[:, 0] *= w / wu
    flow[:, 1] *= h / hu
    return flow


def forward(params: Dict[str, torch.Tensor], x_u8: torch.Tensor, cfg: dict,
            q: Round = None) -> torch.Tensor:
    """uint8 (T, H, W, 3), one segment -> uint8 (T, 4H, 4W, 3), in float32
    arithmetic; with ``q``, every tensor a conv reads, every conv's output
    and every activation and residual sum rounded by it (``make``)."""
    def c(name, z, relu=False):
        return _conv(z, params[f"{name}.conv.weight"], params[f"{name}.conv.bias"], q, relu)

    def r(z):
        return q(z) if q else z

    def trunk(branch, z):
        h = _lrelu(c(f"{branch}.conv_in", z), q)
        for b in range(cfg["blocks"]):
            h = r(h + c(f"{branch}.block{b}.conv1", c(f"{branch}.block{b}.conv0", h, True)))
        return h

    x = x_u8.permute(0, 3, 1, 2).float() / 255.0
    t, _, h, w = x.shape
    flows_b = spynet(params, x[:-1], x[1:], q) if t > 1 else None
    flows_f = spynet(params, x[1:], x[:-1], q) if t > 1 else None
    xq = r(x)
    back = [None] * t
    feat = x.new_zeros(1, cfg["width"], h, w)
    for i in range(t - 1, -1, -1):
        if i < t - 1:
            feat = r(warp(feat, flows_b[i:i + 1].permute(0, 2, 3, 1)))
        feat = back[i] = trunk("backward_trunk", torch.cat([xq[i:i + 1], feat], 1))
    out = []
    feat = torch.zeros_like(feat)
    for i in range(t):
        if i > 0:
            feat = r(warp(feat, flows_f[i - 1:i].permute(0, 2, 3, 1)))
        feat = trunk("forward_trunk", torch.cat([xq[i:i + 1], feat], 1))
        z = _lrelu(c("fusion", torch.cat([back[i], feat], 1)), q)
        z = _lrelu(F.pixel_shuffle(c("up0", z), 2), q)
        z = _lrelu(F.pixel_shuffle(c("up1", z), 2), q)
        z = c("conv_last", _lrelu(c("conv_hr", z), q))
        y = z + F.interpolate(x[i:i + 1], scale_factor=4, mode="bilinear", align_corners=False)
        out.append(torch.round(torch.clamp(255.0 * y, 0.0, 255.0)).to(torch.uint8))
        back[i] = None
    return torch.cat(out).permute(0, 2, 3, 1).contiguous()


def make(params: Dict[str, torch.Tensor], cfg: dict, calibration: Sequence[np.ndarray],
         device, control: bool = False) -> Callable[[np.ndarray], np.ndarray]:
    """uint8 (T, H, W, 3) host segments -> the plain float32 reference's
    uint8 frames. Its attribute ``rounded`` computes the same frames in the
    configuration's ``precision`` (``bfloat16``: the weights and every
    rounding point of ``forward`` rounded to bfloat16, as the port serves
    the model), which the ``clips`` kind reads for each frame's rounding
    noise. The control (``control=True``) is the model computed in float8
    (``fp8_cast``, a scale a tensor, at the same points): the precision
    below bfloat16."""
    if control:
        return _apply(params, cfg, fp8_cast, device)
    apply = _apply(params, cfg, None, device)
    apply.rounded = _apply(params, cfg, ROUND[cfg["precision"]], device)
    return apply


def _apply(params, cfg: dict, q: Round, device) -> Callable[[np.ndarray], np.ndarray]:
    if q is not None:
        params = {k: q(v.float()) for k, v in params.items()}
    return host_apply(lambda x: forward(params, x, cfg, q), device)


ROUND = {"float32": None, "bfloat16": bf16_round}


def conv_precisions(cfg: dict) -> Dict[str, str]:
    """Each conv's serving precision: all of them in the configuration's."""
    return {name: cfg["precision"] for name, *_ in convs(cfg)}
