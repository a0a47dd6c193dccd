"""The int8/bf16 GEMM kernel (``csrc/matmul.cu``), the int8 3x3 conv built on
it, and their plain versions.

Replaces the JAX package's Pallas kernel ``pallas_matmul`` (body
``_mm_kernel``, ``scripts/bench_int8_pallas.py``): a tiled GEMM whose K
loop accumulates in a scratch tile, int8 -> int32 or bf16 -> fp32. Two
entry points share the kernel's tile core:

- ``matmul(a, b)``: (M, K) x (K, N), any M and N; K % 32 for int8 and
  K % 16 for bf16 on the card. The int8 result is exact.
- ``conv3x3_int8(x, w_q, deq, bias, leaky, inv_x)``: the trunk site of
  ``models/quantized.py``'s ``int8_forward`` as an implicit GEMM: x, the
  fp32 stream (B, H, W, Cin) NHWC, requantized with its scale ``inv_x`` as
  the kernel loads it (``requantize``), zero padding 1, ``w_q`` in the
  (9*Cin, Cout) matmul form (rows (dy, dx, cin), as
  ``scatter_params_to_matmul`` lays out K1's kernels), int32 sums, then
  ``float(acc) * deq + bias`` in fp32, each op rounded, and leaky_relu 0.01
  when ``leaky``. fp32 NHWC out. Cin % 32 on the card.

The design and its bound are described at the top of the ``.cu`` file.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..activations import apply_act

LEAKY_SLOPE = 0.01  # the fast trunk's activation (models/fast.py)
# bf16 GEMM, kernel vs plain version: both multiply exactly (bf16 x bf16 is
# exact in fp32) and sum in fp32 against float64; the kernel's fp32 sum over
# K terms of size |a||b| errs by at most about K * 2^-24 of that sum's
# magnitude. Stated as |got - want| <= BF16_ATOL_PER_K * K * max|a| * max|b|.
BF16_ATOL_PER_K = 2.0 ** -22


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the product in float64, then int32 (int8 operands) or
    fp32 (bf16 operands). float64 is exact for int8: |sum| <= K * 127 * 128
    stays far below 2^53 for any K that fits in memory."""
    out = torch.matmul(a.double(), b.double())
    return out.to(torch.int32 if a.dtype == torch.int8 else torch.float32)


def conv3x3_int8_accumulators(x8: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int8 conv's int32 sums, exactly: float64 conv of the int8 values
    (|acc| <= 9 * Cin * 127^2, about 1.9e7 at Cin 128: above 2^24, so fp32
    would round, but far below 2^53)."""
    cin = x8.shape[-1]
    k = w_q.double().reshape(3, 3, cin, -1).permute(3, 2, 0, 1)
    acc = F.conv2d(x8.double().permute(0, 3, 1, 2), k, padding=1)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def requantize(h: torch.Tensor, inv_x: float) -> torch.Tensor:
    """fp32 stream -> int8: ``clip(round(h * inv_x), -127, 127)``, rounding
    half to even as ``jnp.round`` does; ``inv_x`` is an fp32 value."""
    return torch.round(h.float() * inv_x).clamp_(-127, 127).to(torch.int8)


def conv3x3_int8_reference(x, w_q, deq, bias, leaky: bool,
                           inv_x: float | None = None) -> torch.Tensor:
    """Plain version of the int8 conv site: requantize an fp32 ``x``, exact
    sums, then the kernel's fp32 epilogue in the same order (``acc * deq``,
    ``+ bias``, leaky)."""
    x8 = x if inv_x is None else requantize(x, inv_x)
    y = conv3x3_int8_accumulators(x8, w_q).float() * deq + bias
    return apply_act(y, ("leaky_relu", LEAKY_SLOPE)) if leaky else y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._build import load

    lib = load("matmul")
    lib.isr_matmul.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.isr_matmul.restype = ctypes.c_int
    lib.isr_conv3x3_int8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.isr_conv3x3_int8.restype = ctypes.c_int
    lib.isr_matmul_error_string.argtypes = [ctypes.c_int]
    lib.isr_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _library().isr_matmul_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N): int8 -> int32 or bf16 -> fp32. CPU tensors: the
    plain version. CUDA tensors: the hand-written kernel on the current
    stream, or an error."""
    if a.device.type == "cpu":
        return matmul_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.dtype != b.dtype or a.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"matmul takes int8 or bf16 operands, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} x {tuple(b.shape)}")
    int8 = a.dtype == torch.int8
    m, k = a.shape
    n = b.shape[1]
    step = 32 if int8 else 16
    if k == 0 or k % step:
        raise ValueError(f"the kernel needs K a positive multiple of {step}, got {k}")
    _check_operands(a, b)
    out = torch.empty((m, n), dtype=torch.int32 if int8 else torch.float32,
                      device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _library().isr_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                    m, n, k, 0 if int8 else 1, stream)
    _raise_on(err, "matmul")
    matmul.launches += 1
    return out


def conv3x3_int8(x: torch.Tensor, w_q: torch.Tensor, deq: torch.Tensor,
                 bias: torch.Tensor, leaky: bool, inv_x: float) -> torch.Tensor:
    """One int8 trunk site, NHWC: fp32 x with its scale ``inv_x``
    (requantized on load); fp32 out. CPU tensors: the plain version. CUDA
    tensors: the hand-written kernel on the current stream, or an error."""
    if x.device.type == "cpu":
        return conv3x3_int8_reference(x, w_q, deq, bias, leaky, inv_x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or w_q.dtype != torch.int8:
        raise TypeError(f"x must be fp32 and w_q int8, got {x.dtype}, {w_q.dtype}")
    if deq.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("deq and bias must be fp32")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    if cin % 32:
        raise ValueError(f"the kernel needs Cin a multiple of 32, got {cin}")
    if w_q.dim() != 2 or w_q.shape[0] != 9 * cin:
        raise ValueError(f"w_q must be (9*{cin}, Cout), got {tuple(w_q.shape)}")
    cout = w_q.shape[1]
    if deq.numel() != cout or bias.numel() != cout:
        raise ValueError(f"deq and bias must hold {cout} values")
    _check_operands(x, w_q, deq, bias)
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().isr_conv3x3_int8(
            x.data_ptr(), w_q.data_ptr(), deq.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w, cin, cout, int(bool(leaky)), LEAKY_SLOPE,
            float(inv_x), stream)
    _raise_on(err, "conv3x3_int8")
    conv3x3_int8.launches += 1
    return out


matmul.launches = 0
conv3x3_int8.launches = 0
