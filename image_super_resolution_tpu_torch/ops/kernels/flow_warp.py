"""K4 (``csrc/flow_warp.cu``): BasicVSR's flow warp (``models/basicvsr.py``),
a bilinear gather of NHWC features by a float32 optical flow, and its plain
version.

A port kernel with no TPU counterpart: the JAX package has no video model.
BasicSR's ``flow_warp`` (``basicsr/archs/arch_util.py``) samples each
feature map at its pixel grid plus the flow,

    F.grid_sample(x, 2 * (mesh + flow) / (size - 1) - 1, bilinear, align_corners=True)

with ``padding`` "zeros" (the recurrent propagation) or "border" (SPyNet).
The kernel takes the sampling point as ``(j + flow_x, i + flow_y)`` in fp32,
the point the grid sampler's unnormalisation gives back up to a few fp32
ulps, and blends the four corners as the grid sampler does.

With ``frame`` (N, H, W, F) the output is ``[frame, warp(x)]`` (N, H, W,
F + C) in the frame's dtype: the propagation writes the trunk's input
buffer in one launch, with no mesh grid, normalisation or concatenation
beside it. ``x`` may be a channel window of a wider NHWC tensor (its
pixels further apart than C, ``pixel_strides``): the propagation warps both
branches' states, two windows of the tensor that stacks them, in one
launch.

``flow_warp`` is the wrapper, through the op ``isr::flow_warp``: CPU tensors
take the plain version, CUDA tensors the kernel (or an error). It counts
its launches by padding mode in ``flow_warp.launches_by_mode`` and by what
the roofline reads (``perfbench/roofline/k4.py``) in
``flow_warp.launches_by_shape``: (N, H, W, C, F, bytes of an element of x,
bytes of an element of the output) -> launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

THREADS = 256  # per CTA (csrc/flow_warp.cu)
VEC = 8  # channels a thread owns where C and F are multiples of it
PADDING = ("zeros", "border")
# Kernel vs plain version: the sampling point differs by a few fp32 ulps of
# the grid sampler's normalised coordinate (each ~1.2e-7 of (size - 1) / 2,
# under 1e-4 pixel at 480 columns), so an output moves by under 1e-4 of the
# difference of neighbouring inputs, at most 2e-4 of max |x|: ATOL_REL; the
# blend's fp32 sums add ulps of the result, and a bf16 output may round the
# other way: one bf16 ulp, at most 2^-7 of the value.
KERNEL_ATOL_REL = 2.0 ** -12
KERNEL_RTOL = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -7}


def sampling_grid(flow: torch.Tensor) -> torch.Tensor:
    """BasicSR's normalised grid for ``F.grid_sample``: the pixel mesh plus
    the flow (N, H, W, 2; x then y), scaled to [-1, 1] by ``max(size - 1, 1)``."""
    _, h, w, _ = flow.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    v = torch.stack((gx, gy), -1) + flow
    return torch.stack((2.0 * v[..., 0] / max(w - 1, 1) - 1.0,
                        2.0 * v[..., 1] / max(h - 1, 1) - 1.0), -1)


def flow_warp_reference(x: torch.Tensor, flow: torch.Tensor, padding: str,
                        frame: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``F.grid_sample`` in fp32 over BasicSR's grid, rounded
    once to the output dtype; with ``frame``, ``[frame, warp(x)]``."""
    warped = F.grid_sample(x.float().permute(0, 3, 1, 2), sampling_grid(flow.float()),
                           mode="bilinear", padding_mode=padding, align_corners=True)
    warped = warped.permute(0, 2, 3, 1)
    if frame is None:
        return warped.to(x.dtype).contiguous()
    return torch.cat([frame, warped.to(frame.dtype)], -1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("flow_warp")
    lib.isr_flow_warp.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
                                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.isr_flow_warp.restype = ctypes.c_int
    lib.isr_flow_warp_constants.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.isr_flow_warp_constants.restype = None
    got = (ctypes.c_int * 2)()
    lib.isr_flow_warp_constants(got)
    if tuple(got) != (THREADS, VEC):
        raise RuntimeError(f"the kernel's (THREADS, VEC) = {tuple(got)} are not the "
                           f"wrapper's {(THREADS, VEC)}")
    return lib


def pixel_strides(x: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(image stride, pixel stride) in elements of an NHWC ``x`` whose
    channels are adjacent and whose pixels lie a fixed stride apart in
    row-major order: contiguous, or a channel window of a wider NHWC tensor.
    None for any other layout. A dimension of size 1 has no stride to read."""
    n, h, w, c = x.shape
    sn, sh, sw, sc = x.stride()
    pixel = sw if w > 1 else sh if h > 1 else c
    if (c > 1 and sc != 1) or pixel < c or (h > 1 and w > 1 and sh != w * pixel):
        return None
    return (sn if n > 1 else 0), pixel


def flow_warp(x: torch.Tensor, flow: torch.Tensor, padding: str = "zeros",
              frame: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (N, H, W, C) fp32 or bf16 sampled at each pixel plus ``flow``
    (N, H, W, 2) fp32, bilinearly, with ``padding`` "zeros" or "border";
    with ``frame`` (N, H, W, F), ``[frame, warp(x)]`` in the frame's dtype.
    ``x`` contiguous or a channel window (``pixel_strides``); returns
    contiguous NHWC."""
    _build.check_device(x)
    return _op(x, flow, padding, frame)


def _cuda_forward(x, flow, padding, frame) -> torch.Tensor:
    """One launch, counted in ``flow_warp.launches_by_mode`` and
    ``launches_by_shape``."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be fp32 or bf16 (N, H, W, C), got {x.dtype} {tuple(x.shape)}")
    n, h, w, c = x.shape
    if flow.dtype != torch.float32 or tuple(flow.shape) != (n, h, w, 2):
        raise ValueError(f"flow must be fp32 {(n, h, w, 2)}, got {flow.dtype} "
                         f"{tuple(flow.shape)}")
    if padding not in PADDING:
        raise ValueError(f"padding must be one of {PADDING}, got {padding!r}")
    f = 0 if frame is None else frame.shape[-1]
    if frame is not None and (frame.dim() != 4 or tuple(frame.shape[:3]) != (n, h, w)
                              or frame.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"frame must be fp32 or bf16 {(n, h, w, 'F')}, got {frame.dtype} "
                         f"{tuple(frame.shape)}")
    strides = pixel_strides(x)
    if strides is None:
        raise ValueError(f"x must be NHWC with adjacent channels and evenly spaced pixels, got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    out = torch.empty((n, h, w, f + c), dtype=x.dtype if frame is None else frame.dtype,
                      device=x.device)
    if flow.device != x.device:
        raise ValueError("all operands must be on one device")
    vec = c % VEC == 0 and f % VEC == 0 and all(s % VEC == 0 for s in strides)
    align = 16 if vec else 1
    if x.data_ptr() % align:
        raise ValueError(f"x must be {align}-byte aligned")
    _build.check_operands(frame, out, align=align)
    _build.check_operands(flow, align=8)
    if out.numel() == 0:
        return out
    _build.launch(_library(), "isr_flow_warp", x.device, x.data_ptr(), flow.data_ptr(),
                  0 if frame is None else frame.data_ptr(), out.data_ptr(), n, h, w, c, f,
                  *strides, int(x.dtype == torch.float32), int(out.dtype == torch.float32),
                  int(padding == "border"), int(vec))
    modes = flow_warp.launches_by_mode
    modes[padding] = modes.get(padding, 0) + 1
    key = (n, h, w, c, f, x.element_size(), out.element_size())
    flow_warp.launches_by_shape[key] = flow_warp.launches_by_shape.get(key, 0) + 1
    return out


def _fake(x, flow, padding, frame):
    f = 0 if frame is None else frame.shape[-1]
    return x.new_empty((*x.shape[:3], f + x.shape[3]),
                       dtype=x.dtype if frame is None else frame.dtype)


_op = _build.register(
    "flow_warp", "(Tensor x, Tensor flow, str padding, Tensor? frame) -> Tensor",
    flow_warp_reference, _cuda_forward, _fake)

flow_warp.launches_by_mode = {}  # "zeros" / "border" -> launches
flow_warp.launches_by_shape = {}  # (N, H, W, C, F, x bytes, out bytes) -> launches
