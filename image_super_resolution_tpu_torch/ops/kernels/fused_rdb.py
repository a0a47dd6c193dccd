"""The fused RDB kernel (``csrc/fused_rdb.cu``) and its plain version.

Replaces the JAX package's Pallas kernel ``scatter_rdb_pallas``
(``ops/pallas/fused_rdb.py``): one whole scatter-form RDB (ops/scatter.py)
over NHWC bf16 activations with C=64, g=32. Five 3x3 convs with fp32
accumulation: ``sx`` 9C->4g+C, ``s0`` 9g->3g+C, ``s1`` 9g->2g+C,
``s2`` 9g->g+C, ``s3`` 9g->C; the bias goes on the first; each
``y_i = bf16(leaky(fp32 running sum of its slices))``; the output is
``bf16(fuse * add_rate + x)``.

The kernel computes the same function in dense (gather) form: launch i
gathers every source that exists so far through its column slice of the
scatter-form weights (``dense_plan``), so no fp32 partial sum leaves the
chip. Unlike the Pallas kernel it takes any batch and any H, W (whole-image
serving sends non-square images through it). Each launch runs on
``tile_schedule``'s persistent grid: min(rectangles, SMs) blocks, block k
walking rectangles k, k + grid, ... . The CUDA design and its bound are
described at the top of the ``.cu`` file.

The wrapper ``scatter_rdb`` calls the op ``isr::scatter_rdb``
(``_build.register``): CPU -> the plain version, CUDA -> the counted
launch. Counters, plain integers on ``scatter_rdb``: ``launches`` (RDB
calls on the card), ``tiles`` (rectangles walked, all five launches) and
``blocks`` (blocks started, all five launches); ``tiles / blocks`` says
how far each block's load ring runs on across rectangles.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..conv import same_conv
from . import _build

C = 64  # block width the kernel is written for
G = C // 2  # growth channels
PC = 4 * G + C  # output channels of sx; the bias's length
COUTS = (PC, PC - G, PC - 2 * G, PC - 3 * G, C)  # of sx, s0..s3
MAX_GROUPS = 6  # 32-channel source groups of the last launch
RECT = (24, 24)  # the kernel's output rectangle, rows x columns
LAUNCHES = 5

# Kernel vs plain version in bf16: both keep fp32 sums and round at the same
# places, but sum each conv in another order. That can flip the bf16
# rounding of some y_i, moving the output by about one bf16 ulp of a
# unit-scale value (2^-7); allow a few: |got - want| <= ATOL + RTOL * |want|.
KERNEL_ATOL = 2.0 ** -5
KERNEL_RTOL = 2.0 ** -7


def scatter_params_to_matmul(scatter: Dict[str, Any], dtype=torch.bfloat16
                             ) -> Tuple[torch.Tensor, ...]:
    """ScatterRDB params (HWIO kernels) -> the (9*Cin, Cout) matmul forms,
    rows kernel-major (dy, dx, cin), in ``dtype``; bias (1, 4g+C) fp32."""
    def flat(k):
        k = np.asarray(k, np.float32)
        kh, kw, cin, cout = k.shape
        return torch.from_numpy(k.reshape(kh * kw * cin, cout).copy()).to(dtype)

    bias = np.asarray(scatter["bias"], np.float32).reshape(1, -1)
    return (
        flat(scatter["sx"]), flat(scatter["s0"]), flat(scatter["s1"]),
        flat(scatter["s2"]), flat(scatter["s3"]), torch.from_numpy(bias.copy()),
    )


def scatter_rdb_reference(x, sx, s0, s1, s2, s3, bias, add_rate: float = 0.2,
                          slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch version of the kernel, NHWC in and out.

    The convs run in fp32 on the given values (bf16 x bf16 products are
    exact in fp32); each ``y_i`` and the output are rounded to ``x.dtype``.
    For fp32 input this is the JAX ``ScatterRDB`` in fp32; for bf16 input it
    is the Pallas kernel's numerics (fp32 running sums, bf16 ``y_i``)."""
    dt = x.dtype
    g = x.shape[-1] // 2

    def conv(v, w):  # v NHWC, w (9*Cin, Cout) -> fp32 NHWC
        cin = v.shape[-1]
        k = w.float().reshape(3, 3, cin, -1).permute(3, 2, 0, 1).contiguous()
        return same_conv(v.float(), k)

    def act(s):
        return F.leaky_relu(s, slope).to(dt)

    cx = conv(x, sx) + bias.float().reshape(-1)
    y0 = act(cx[..., :g])
    c0 = conv(y0, s0)
    y1 = act(cx[..., g:2 * g] + c0[..., :g])
    c1 = conv(y1, s1)
    y2 = act(cx[..., 2 * g:3 * g] + c0[..., g:2 * g] + c1[..., :g])
    c2 = conv(y2, s2)
    y3 = act(cx[..., 3 * g:4 * g] + c0[..., 2 * g:3 * g] + c1[..., g:2 * g]
             + c2[..., :g])
    c3 = conv(y3, s3)
    fuse = cx[..., 4 * g:] + c0[..., 3 * g:] + c1[..., 2 * g:] + c2[..., g:] + c3
    return (fuse * add_rate + x.float()).to(dt)


def dense_plan() -> List[Dict[str, Any]]:
    """The kernel's five launches, in order. Launch i computes y_i (i < 4,
    N = g outputs into channels [ig, (i+1)g) of the y buffer) or the output
    (i = 4, N = C), summing in this order over 32-channel source groups
    ``(source, channel0, weight, weight channel0, column0)``: channels
    [channel0, channel0+32) of ``source`` ("x" or the y buffer "y") through
    the rows ``tap * Cin + weight channel0 + 0..31`` (tap 0..8) and columns
    [column0, column0 + N) of weight ``weight`` (0 = sx, 1..4 = s0..s3).
    Then bias[bias0 : bias0 + N]."""
    plan = []
    for i in range(LAUNCHES):
        last = i == LAUNCHES - 1
        groups = [("x", c0, 0, c0, i * G) for c0 in (0, G)]
        groups += [("y", j * G, j + 1, 0, (i - j - 1) * G) for j in range(i)]
        plan.append({"groups": groups, "n": C if last else G, "bias0": i * G,
                     "dst": "out" if last else "y", "dst_c0": 0 if last else i * G})
    return plan


def _plan_ints() -> List[int]:
    """``dense_plan`` as the integers ``isr_fused_rdb_forward`` reads."""
    ints = []
    for launch in dense_plan():
        ints += [len(launch["groups"]), launch["n"], launch["bias0"],
                 int(launch["dst"] == "out"), launch["dst_c0"]]
        for src, c0, w, wc0, col0 in launch["groups"]:
            ints += [int(src == "y"), c0, w, wc0, col0]
        ints += [0] * 5 * (MAX_GROUPS - len(launch["groups"]))
    return ints


def tile_schedule(b: int, h: int, w: int, sms: int) -> Tuple[int, int]:
    """(rectangles, blocks) of each launch on a (b, h, w) input: RECT
    rectangles cover every image, ragged at the right and bottom edges, and
    a launch starts one persistent block per SM, or one per rectangle where
    there are fewer."""
    tiles = b * -(-h // RECT[0]) * -(-w // RECT[1])
    return tiles, min(tiles, sms)


def _schedule(x) -> Tuple[int, int]:
    b, h, w, _ = x.shape
    return tile_schedule(b, h, w, _build.sm_count(x.device))


@functools.lru_cache(maxsize=None)
def _library() -> Tuple[ctypes.CDLL, Any]:
    lib = _build.load("fused_rdb")
    fn = lib.isr_fused_rdb_forward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ints = _plan_ints()
    if len(ints) != 5 * lib.isr_fused_rdb_plan_ints():
        raise RuntimeError("csrc/fused_rdb.cu reads another plan layout")
    if tuple(lib.isr_fused_rdb_rectangle(d) for d in (0, 1)) != RECT:
        raise RuntimeError("csrc/fused_rdb.cu walks other rectangles than tile_schedule")
    return lib, (ctypes.c_int * len(ints))(*ints)


def _check(x, weights, bias) -> None:
    if x.dim() != 4 or x.shape[-1] != C:
        raise ValueError(f"x must be (B, H, W, {C}), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got {x.dtype}")
    cins = (C, G, G, G, G)
    for name, w, cin, cout in zip(("sx", "s0", "s1", "s2", "s3"), weights,
                                  cins, COUTS):
        if w.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bf16, got {w.dtype}")
        if tuple(w.shape) != (9 * cin, cout):
            raise ValueError(f"{name} must be {(9 * cin, cout)}, got {tuple(w.shape)}")
    if bias.dtype != torch.float32 or bias.numel() != PC:
        raise ValueError(f"bias must be {PC} fp32 values, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    _build.check_operands(x, *weights, bias)


def scatter_rdb(x, sx, s0, s1, s2, s3, bias, add_rate: float = 0.2,
                slope: float = 0.01) -> torch.Tensor:
    """One scatter-form RDB, NHWC, through the op ``isr::scatter_rdb``. CPU
    tensor: the plain version. CUDA tensor: the hand-written kernel, on the
    current stream, or an error. Traced by ``torch.export``, it is one node
    of the graph."""
    _build.check_device(x)
    return _op(x, sx, s0, s1, s2, s3, bias, float(add_rate), float(slope))


def _cuda_forward(x, sx, s0, s1, s2, s3, bias, add_rate, slope) -> torch.Tensor:
    """The kernel's five launches, counted as one in ``scatter_rdb.launches``,
    and their rectangles and blocks in ``scatter_rdb.tiles`` and ``.blocks``."""
    out = _launch(x, (sx, s0, s1, s2, s3), bias, add_rate, slope)[0]
    scatter_rdb.launches += 1
    if x.numel():
        tiles, grid = _schedule(x)
        scatter_rdb.tiles += LAUNCHES * tiles
        scatter_rdb.blocks += LAUNCHES * grid
    return out


_op = _build.register(
    "scatter_rdb", "(Tensor x, Tensor sx, Tensor s0, Tensor s1, Tensor s2, Tensor s3, "
    "Tensor bias, float add_rate, float slope) -> Tensor",
    scatter_rdb_reference, _cuda_forward, lambda x, *args: torch.empty_like(x))


def _launch(x, weights, bias, add_rate, slope, only: int = -1, y=None, out=None):
    """Run the kernel's launches (all five, or launch ``only``) on CUDA
    tensors: (output, y buffer). ``y`` and ``out`` may be passed in, as the
    per-launch timing does; otherwise they are allocated."""
    _check(x, weights, bias)
    b, h, w, _ = x.shape
    if out is None:
        out = torch.empty_like(x)
    if y is None:
        y = torch.empty((b, h, w, 4 * G), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out, y
    lib, plan = _library()
    _build.launch(lib, "isr_fused_rdb_forward", x.device, x.data_ptr(),
                  *(t.data_ptr() for t in weights), bias.data_ptr(), y.data_ptr(),
                  out.data_ptr(), b, h, w, float(add_rate), float(slope), plan, only,
                  _schedule(x)[1])
    return out, y


scatter_rdb.launches = 0
scatter_rdb.tiles = 0
scatter_rdb.blocks = 0
