"""Post-training int8 serving for the fast families (counterpart of the JAX
package's ``models/quantized.py``).

Scheme (symmetric PTQ):

- weights: per-output-channel int8, scale = max|w[..., o]| / 127;
- activations: one static scale per trunk conv input, calibrated on sample
  batches (max of |x|, or a percentile of it) over the bf16 forward;
- the 2*depth+1 trunk convs (``trunk_sites``) run int8 x int8 -> int32 in
  ``ops/kernels/matmul.py``'s ``conv3x3_int8`` (the hand-written kernel on
  the card), dequantized in its epilogue (``acc * deq + bias``, leaky on
  conv0 sites); the residual stream between them stays fp32, and each
  site's input is its fp32 value requantized (``clip(round(h * inv_x),
  +-127)``, inv_x = 1 / s_x in fp32). Only block 0's conv0 requantizes as
  it loads (the head is a bf16 conv); every other site is handed its input
  in int8 by the site before it, whose epilogue requantizes with the next
  site's ``inv_x`` (the same function): a conv0 its own output, a conv1 the
  block's sum ``h + add_rate * t``, which it computes in its epilogue and
  also stores in fp32 for the next block's residual (the last conv1
  stores int8 only); ``trunk_conv``'s epilogue adds the global skip;
- head, tail and the refinement tail stay bf16.

``fast_forward`` is ``models/fast.py``'s forward written as a function of a
param dict (the port's ``state_dict`` names), with the JAX hooks: ``record``
sees every trunk conv input (calibration) and ``quant`` replaces every
trunk conv, the residual stream then in fp32 torch ops (the unfused int8
route, which ``int8_forward`` equals bit for bit). Without hooks it is the
bf16 module's forward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.transforms import normalize, tanh_to_uint8
from ..ops.activations import apply_act, dtype_scalar
from ..ops.conv import conv_bias_nhwc
from ..ops.kernels.matmul import conv3x3_int8, weights_k_major
from ..ops.pixel_shuffle import pixel_shuffle
from ..utils.profiling import annotate
from .deploy import upload
from .fast import _LEAKY, downshuffle_front, scale_residual

FAMILIES = ("fast", "denoise_fast")
# Largest uint8 difference allowed between the card's int8 output and the
# port's int8 CPU path on the same quantized params (fast x4, depth 14).
# The int8 sites agree exactly; the bf16 head and tail convs (cuDNN against
# the CPU) can flip a bf16 rounding, which requantization at the next site
# turns into a whole int8 step. Measured on an H100 (chip_smoke.py, two
# 24x24 tiles): 1 LSB on 0.01% of the values; bound 4.
INT8_CARD_MAX_LSB = 4


def trunk_sites(depth: int):
    """Names of the quantized conv sites, in forward order."""
    for i in range(depth):
        yield f"block{i}.conv0"
        yield f"block{i}.conv1"
    yield "trunk_conv"


def _bf16_conv_act(x: torch.Tensor, params, name: str, act: bool) -> torch.Tensor:
    """One ConvBlock as flax runs it in bf16: bf16 operands, conv rounded to
    bf16, + bf16 bias, optional leaky_relu."""
    w = params[f"{name}.conv.weight"].to(torch.bfloat16)
    y = conv_bias_nhwc(x.to(torch.bfloat16), w, params[f"{name}.conv.bias"],
                       padding=w.shape[-1] // 2)
    return apply_act(y, _LEAKY) if act else y


def _head(params: Dict[str, Any], x: torch.Tensor, downshuffle: int) -> torch.Tensor:
    return _bf16_conv_act(downshuffle_front(x.to(torch.bfloat16), downshuffle), params,
                          "head", act=True)


def _tail(params: Dict[str, Any], x: torch.Tensor, add_rate: float, r: int,
          refine_blocks: int) -> torch.Tensor:
    """The trunk's output (after the global skip) -> tanh output at ``r``
    times the trunk's resolution, in bf16."""
    if refine_blocks:
        x = _bf16_conv_act(x, params, "refine_proj", act=True)
        if r > 1:
            x = pixel_shuffle(x, r)
        for i in range(refine_blocks):
            t = _bf16_conv_act(x, params, f"refine{i}.conv0", act=True)
            t = _bf16_conv_act(t, params, f"refine{i}.conv1", act=False)
            x = x + scale_residual(t, add_rate)
        return torch.tanh(_bf16_conv_act(x, params, "tail", act=False))
    x = torch.tanh(_bf16_conv_act(x, params, "tail", act=False))
    return pixel_shuffle(x, r) if r > 1 else x


def fast_forward(
    params: Dict[str, Any],
    x: torch.Tensor,
    depth: int,
    add_rate: float,
    scale: int,
    record: Optional[Callable[[str, torch.Tensor], None]] = None,
    quant: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
    downshuffle: int = 1,
    refine_blocks: int = 0,
) -> torch.Tensor:
    """FastSRGenerator's forward on a param dict. ``record(site, h)`` is
    called with every trunk conv input; ``quant(site, h)`` replaces each
    trunk conv (conv + bias + act for conv0 sites, conv + bias for the
    rest), and then the residual stream runs in fp32."""
    stream = torch.float32 if quant is not None else torch.bfloat16

    def site_conv(site, h, act):
        if record is not None:
            record(site, h)
        if quant is not None:
            return quant(site, h)
        return _bf16_conv_act(h, params, site, act)

    h_in, w_in = x.shape[1], x.shape[2]
    x = _head(params, x, downshuffle).to(stream)
    h = x
    for i in range(depth):
        t = site_conv(f"block{i}.conv0", h, act=True)
        t = site_conv(f"block{i}.conv1", t, act=False)
        h = h + scale_residual(t.to(stream), add_rate)
    x = x + site_conv("trunk_conv", h, act=False).to(stream)
    x = _tail(params, x, add_rate, scale * downshuffle, refine_blocks)
    return x[:, :h_in * scale, :w_in * scale].float()


# ------------------------------------------------------------ calibration --


def linear_percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a.ravel(), q)`` (linear interpolation between the
    two order statistics around q/100 * (n - 1)), by ``torch.kthvalue``:
    ``torch.quantile`` refuses inputs above 2^24 elements. Returns a 0-d
    tensor on ``a``'s device, with no host sync."""
    flat = a.reshape(-1)
    n = flat.numel()
    pos = q / 100.0 * (n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = pos - lo
    lo_v = torch.kthvalue(flat, lo + 1).values
    if hi == lo:
        return lo_v
    hi_v = torch.kthvalue(flat, hi + 1).values
    return lo_v * (1.0 - w_hi) + hi_v * w_hi


def check_percentile(p: Optional[float]) -> None:
    """A calibration percentile must lie in (0, 100]."""
    if p is not None and not 0.0 < p <= 100.0:
        raise ValueError(f"int8 calibration percentile must be in (0, 100], got {p}")


@torch.inference_mode()
def calibrate_scales(
    params: Dict[str, Any],
    batches: Iterable[torch.Tensor],
    depth: int,
    add_rate: float,
    scale: int,
    downshuffle: int = 1,
    refine_blocks: int = 0,
    percentile: Optional[float] = None,
) -> Dict[str, float]:
    """Static per-site activation scales: the max over the batches of
    max|x| (or its ``percentile``-th percentile) at every trunk conv input
    of the bf16 forward, / 127. ``batches``: normalized float NHWC."""
    check_percentile(percentile)
    maxes: Dict[str, float] = {}
    for x in batches:
        seen: Dict[str, torch.Tensor] = {}

        def record(site, t):
            a = t.float().abs()
            seen[site] = (a.max() if percentile is None
                          else linear_percentile(a, percentile))

        fast_forward(params, x, depth, add_rate, scale, record=record,
                     downshuffle=downshuffle, refine_blocks=refine_blocks)
        # one device->host copy for all sites of the batch
        for site, m in zip(seen, torch.stack(list(seen.values())).tolist()):
            maxes[site] = max(maxes.get(site, 0.0), float(m))
    if not maxes:
        raise ValueError("calibrate_scales needs at least one batch")
    # guard degenerate all-zero activations (scale 0 would divide by zero)
    return {site: max(m, 1e-8) / 127.0 for site, m in maxes.items()}


def quantize_fast_params(params: Dict[str, Any], act_scales: Dict[str, float],
                         depth: int) -> Dict[str, Any]:
    """Param dict -> int8 serving dict, on the host. Per site: ``w_q`` int8
    in the (9*Cin, Cout) matmul form, ``inv_x`` (an fp32 value, as a Python
    float the kernel takes by value), ``deq`` =
    act_scale * per-channel weight scale, ``bias`` (fp32). Head, tail and
    refinement params pass through."""
    q: Dict[str, Any] = {k: v for k, v in params.items()
                         if k.startswith(("head.", "tail.", "refine"))}
    for site in trunk_sites(depth):
        w = params[f"{site}.conv.weight"].detach().float().cpu().numpy()
        w = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO, as the JAX tree holds it
        w_scale = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-12) / 127.0
        w_q = np.clip(np.rint(w / w_scale), -127, 127).astype(np.int8)
        s_x = float(act_scales[site])
        q[site] = {
            "w_q": torch.from_numpy(np.ascontiguousarray(w_q.reshape(-1, w.shape[3]))),
            "inv_x": float(np.float32(1.0 / s_x)),
            "deq": torch.from_numpy(np.asarray(s_x * w_scale, np.float32)),
            "bias": params[f"{site}.conv.bias"].detach().float().cpu(),
        }
    return q


def quant_site(p: Dict[str, Any], h: torch.Tensor, leaky: bool,
               out_inv_x: Optional[float] = None, res: Optional[torch.Tensor] = None,
               rate: float = 1.0, keep_fp32: bool = False):
    """One int8 trunk site: the fp32 input requantized with the site's
    scale (inside the kernel on the card), or an int8 input as it is; the
    int8 conv and its dequantizing epilogue, then ``res + y * rate`` when
    ``res`` is given; fp32 out, or int8 requantized with ``out_inv_x`` (the
    next site's scale), or both with ``keep_fp32``."""
    return conv3x3_int8(h, p["w_q"], p["deq"], p["bias"], leaky=leaky,
                        inv_x=None if h.dtype == torch.int8 else p["inv_x"],
                        out_inv_x=out_inv_x, w_k=p.get("w_k"), res=res, rate=rate,
                        keep_fp32=keep_fp32)


def int8_forward(qparams: Dict[str, Any], x: torch.Tensor, depth: int,
                 add_rate: float, scale: int, downshuffle: int = 1,
                 refine_blocks: int = 0) -> torch.Tensor:
    """Serving forward with the trunk convs in int8 (int32 sums), each site
    handed its input in int8 by the one before it (block 0's conv0 takes
    the head's fp32 output): a conv0 requantizes its output with its
    conv1's scale; a conv1 finishes its block, ``h + add_rate * t`` in its
    epilogue, stored in fp32 (the next block's residual; not after the
    last block, whose sum only ``trunk_conv`` reads) and in int8 with the
    next site's scale; ``trunk_conv`` adds the head's output. The same
    values, bit for bit, as ``fast_forward`` with a ``quant`` that runs
    each site on its fp32 input."""
    h_in, w_in = x.shape[1], x.shape[2]
    x = _head(qparams, x, downshuffle).float()
    rate = dtype_scalar(add_rate, torch.float32)
    h, h8 = x, None  # the fp32 stream, and its int8 copy for the next site
    for i in range(depth):
        conv0, conv1 = qparams[f"block{i}.conv0"], qparams[f"block{i}.conv1"]
        last = i == depth - 1
        nxt = qparams["trunk_conv" if last else f"block{i + 1}.conv0"]["inv_x"]
        t8 = quant_site(conv0, h if h8 is None else h8, leaky=True, out_inv_x=conv1["inv_x"])
        if last:
            h, h8 = None, quant_site(conv1, t8, leaky=False, out_inv_x=nxt, res=h, rate=rate)
        else:
            h, h8 = quant_site(conv1, t8, leaky=False, out_inv_x=nxt, res=h, rate=rate,
                               keep_fp32=True)
    x = quant_site(qparams["trunk_conv"], x if h8 is None else h8, leaky=False, res=x)
    x = _tail(qparams, x, add_rate, scale * downshuffle, refine_blocks)
    return x[:, :h_in * scale, :w_in * scale].float()


# ------------------------------------------------------------- deployment --


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class Int8DeployedFast:
    """uint8 NHWC -> uint8 NHWC int8-trunk server with ``DeployedModel``'s
    call surface, so ``TiledUpscaler`` takes it unchanged. Build it with
    :func:`quantize_deployed`. ``params`` (the int8 dict) is committed to
    ``device`` once, here; on the card each site also gets ``w_k``, the
    kernel's K-major copy of ``w_q``, laid out here once."""

    def __init__(self, spec, params: Dict[str, Any], device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        if self.device.type == "cuda":
            for site in trunk_sites(spec.depth):
                p = self.params[site]  # a copy: _to_device builds new dicts
                p["w_k"] = weights_k_major(p["w_q"])
        self._mean = tuple(float(v) for v in spec.mean)
        self._std = tuple(float(v) for v in spec.std)

    def replica(self, device) -> "Int8DeployedFast":
        """The same int8 server on ``device``: the same calibrated scales
        and quantized weights, with its own K-major ``w_k`` there. Calibrate
        once and replicate, so that the output does not depend on the
        device count."""
        params = {k: ({kk: vv for kk, vv in v.items() if kk != "w_k"}
                      if isinstance(v, dict) else v)
                  for k, v in self.params.items()}
        return Int8DeployedFast(self.spec, params, device)

    @torch.inference_mode()
    def __call__(self, u8_batch) -> torch.Tensor:
        """uint8 NHWC (numpy or tensor) -> uint8 NHWC tensor on the device.
        The spans ``model/upload`` and ``model/forward``, as
        ``DeployedModel``'s."""
        spec = self.spec
        x = upload(u8_batch, self.device)
        with annotate("model/forward"):
            y = int8_forward(self.params, normalize(x, self._mean, self._std), spec.depth,
                             spec.add_rate, spec.output_scale,
                             downshuffle=spec.downshuffle or 1,
                             refine_blocks=spec.refine_blocks or 0)
            return tanh_to_uint8(y)


def quantize_deployed(deployed, calib_u8_batches, percentile: Optional[float] = None
                      ) -> Int8DeployedFast:
    """PTQ a fast-family ``DeployedModel`` with uint8 calibration batches
    (e.g. crops of the images being served). Weight scales come from the
    deployed (dtype-committed) weights; the activation scales from the
    bf16 forward on the deployed model's device."""
    spec = deployed.spec
    if spec.family not in FAMILIES:
        raise ValueError(
            "int8 serving is built for the fast families only; got "
            f"family={spec.family!r}: the reference topologies' int8 was "
            "measured dead at their conv shapes"
        )
    check_percentile(percentile)
    device = deployed.device
    params = dict(deployed.model.state_dict())
    mean = tuple(float(v) for v in spec.mean)
    std = tuple(float(v) for v in spec.std)
    batches = [normalize(torch.as_tensor(b).to(device), mean, std)
               for b in calib_u8_batches]
    scales = calibrate_scales(params, batches, spec.depth, spec.add_rate,
                              spec.output_scale, downshuffle=spec.downshuffle or 1,
                              refine_blocks=spec.refine_blocks or 0,
                              percentile=percentile)
    qtree = quantize_fast_params(params, scales, spec.depth)
    # head/tail/refine run in bf16: cast them once, not per call
    qtree = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v)
             for k, v in qtree.items()}
    return Int8DeployedFast(spec, qtree, device)
