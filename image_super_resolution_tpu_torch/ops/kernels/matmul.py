"""K2 (``csrc/matmul.cu``, wgmma): the int8 3x3 conv site, the int8/bf16
GEMM, and their plain versions.

Replaces the JAX package's Pallas kernel ``pallas_matmul`` (body
``_mm_kernel``, ``scripts/bench_int8_pallas.py``): a tiled GEMM whose K
loop accumulates in a scratch tile, int8 -> int32 or bf16 -> fp32. Two
entry points:

- ``conv3x3_int8(x, w_q, deq, bias, leaky, inv_x, out_inv_x, w_k, res,
  rate, keep_fp32)``: the trunk site of ``models/quantized.py``'s
  ``int8_forward`` as an implicit GEMM, NHWC, zero padding 1. ``x`` is the
  fp32 stream with its scale ``inv_x`` (requantized as the kernel loads
  it, ``requantize``) or int8 with ``inv_x=None``. ``w_q`` is the
  (9*Cin, Cout) matmul form (rows (dy, dx, cin), as the JAX package holds
  it); the kernel reads its K-major copy ``w_k = weights_k_major(w_q)``,
  which callers lay out once and pass in (required on the card). int32
  sums, then ``float(acc) * deq + bias`` in fp32, each op rounded,
  leaky_relu 0.01 when ``leaky``; with ``res`` (fp32, the output's shape)
  the residual update ``res + y * rate``, two rounded ops (a conv1 site
  finishing its block, ``trunk_conv`` the global skip). fp32 out; or,
  with ``out_inv_x``, int8 requantized with that scale (a conv0 site
  handing off to its conv1, a conv1 site to the next block's conv0); or,
  with ``keep_fp32`` too, both. Cin % 32 on the card; any Cout, B, H, W.
- ``matmul(a, b)``: (M, K) x (K, N), any M and N; K % 32 for int8 and
  K % 16 for bf16 on the card. The int8 result is exact. The kernel reads
  both operands K-major, so each call first transposes B (a small kernel
  of the same library, any N).

The design and its bound are described at the top of the ``.cu`` file;
``conv_plan`` is the conv's launch plan, computed here and passed to the
kernel as integers.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..activations import apply_act
from . import _build

LEAKY_SLOPE = 0.01  # the fast trunk's activation (models/fast.py)
# The conv kernel's tiling (csrc/matmul.cu: RH, RW, NT, MAX_CC; _library()
# refuses a build whose tiling differs).
RECT_H, RECT_W = 24, 8
N_TILE = 128
MAX_CHUNK = 128
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


def conv3x3_int8_reference(x, w_q, deq, bias, leaky: bool, inv_x: float | None = None,
                           out_inv_x: float | None = None, res: torch.Tensor | None = None,
                           rate: float = 1.0, keep_fp32: bool = False):
    """Plain version of the int8 conv site: requantize an fp32 ``x`` (int8
    ``x`` is taken as it is), exact sums, then the kernel's fp32 epilogue in
    the same order (``acc * deq``, ``+ bias``, leaky, ``res + y * rate``
    when ``res`` is given), requantized with ``out_inv_x`` when it is
    given, and then returned beside the fp32 values when ``keep_fp32``."""
    x8 = x if inv_x is None else requantize(x, inv_x)
    y = conv3x3_int8_accumulators(x8, w_q).float() * deq + bias
    if leaky:
        y = apply_act(y, ("leaky_relu", LEAKY_SLOPE))
    if res is not None:
        y = res + y * rate
    if out_inv_x is None:
        return y
    q = requantize(y, out_inv_x)
    return (y, q) if keep_fp32 else q


def weights_k_major(w_q: torch.Tensor) -> torch.Tensor:
    """(9*Cin, Cout) int8 -> the kernel's K-major (Npad, 9*Cin) copy: row o
    holds output channel o's 9*Cin weights, Npad = Cout rounded up to the
    kernel's N_TILE, the extra rows zero (wgmma's int8 B operand must be
    K-major; its transpose bit exists only for 16-bit types)."""
    k, cout = w_q.shape
    out = torch.zeros((-(-cout // N_TILE) * N_TILE, k), dtype=w_q.dtype, device=w_q.device)
    out[:cout] = w_q.t()
    return out


def conv_plan(b: int, h: int, w: int, cin: int, cout: int, sms: int) -> dict:
    """The conv kernel's launch plan: K chunks of ``cc`` input channels (all
    of Cin up to MAX_CHUNK, whose weights then stay in shared memory; else
    the largest multiple of 32 up to MAX_CHUNK that divides Cin), RECT_H x
    RECT_W output rectangles per image, ``n_tiles`` blocks of N_TILE output
    channels, and ``grid_x`` persistent blocks per N tile (one per SM in
    all, at most one per rectangle), each walking rectangles grid_x apart."""
    if cin <= 0 or cin % 32:
        raise ValueError(f"the kernel needs Cin a positive multiple of 32, got {cin}")
    cc = cin if cin <= MAX_CHUNK else max(c for c in range(32, MAX_CHUNK + 1, 32)
                                          if cin % c == 0)
    rects_h, rects_w = -(-h // RECT_H), -(-w // RECT_W)
    rects = b * rects_h * rects_w
    n_tiles = -(-cout // N_TILE)
    return {"cc": cc, "chunks": cin // cc, "rects_h": rects_h, "rects_w": rects_w,
            "rects": rects, "n_tiles": n_tiles,
            "grid_x": max(1, min(rects, sms // n_tiles))}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("matmul")
    lib.isr_matmul.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.isr_matmul.restype = ctypes.c_int
    tiling = bind_conv(lib)
    if tiling != (RECT_H, RECT_W, N_TILE, MAX_CHUNK):
        raise RuntimeError(f"the conv kernel's tiling (RH, RW, NT, MAX_CC) = {tiling} is "
                           f"not the wrapper's {(RECT_H, RECT_W, N_TILE, MAX_CHUNK)}")
    lib.isr_conv3x3_int8_smem_bytes.argtypes = [ctypes.c_int]
    lib.isr_conv3x3_int8_smem_bytes.restype = ctypes.c_int
    lib.isr_matmul_smem_bytes.argtypes = []
    lib.isr_matmul_smem_bytes.restype = ctypes.c_int
    lib.isr_transpose.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.isr_transpose.restype = ctypes.c_int
    return lib


def bind_conv(lib: ctypes.CDLL) -> tuple:
    """Declare ``isr_conv3x3_int8``'s C signature on a library built from
    ``csrc/matmul.cu`` (or a variant of it) and return the tiling it was
    built with, (RH, RW, NT, MAX_CC)."""
    lib.isr_conv3x3_int8.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.isr_conv3x3_int8.restype = ctypes.c_int
    lib.isr_conv3x3_int8_tiling.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.isr_conv3x3_int8_tiling.restype = None
    tiling = (ctypes.c_int * 4)()
    lib.isr_conv3x3_int8_tiling(tiling)
    return tuple(tiling)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N): int8 -> int32 or bf16 -> fp32, through the op
    ``isr::matmul``. CPU tensors: the plain version. CUDA tensors: the
    hand-written kernel on the current stream, or an error."""
    _build.check_device(a)
    return _matmul(a, b)


def _matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The transposed copy of B and the GEMM, counted in ``matmul.launches``."""
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
    _build.check_operands(a, b)
    out = torch.empty((m, n), dtype=torch.int32 if int8 else torch.float32,
                      device=a.device)
    if m == 0 or n == 0:
        return out
    # wgmma reads both operands K-major (its transpose bit exists only for
    # 16-bit types): one transposed copy of B per call, part of its time
    bt = torch.empty((n, k), dtype=b.dtype, device=b.device)
    _build.launch(_library(), "isr_transpose", a.device, b.data_ptr(), bt.data_ptr(), k, n,
                  b.element_size())
    _build.launch(_library(), "isr_matmul", a.device, a.data_ptr(), bt.data_ptr(),
                  out.data_ptr(), m, n, k, 0 if int8 else 1)
    matmul.launches += 1
    return out


_matmul = _build.register(
    "matmul", "(Tensor a, Tensor b) -> Tensor", matmul_reference, _matmul_cuda,
    lambda a, b: a.new_empty((a.shape[0], b.shape[1]),
                             dtype=torch.int32 if a.dtype == torch.int8 else torch.float32))


def conv3x3_int8(x: torch.Tensor, w_q: torch.Tensor, deq: torch.Tensor,
                 bias: torch.Tensor, leaky: bool, inv_x: float | None = None,
                 out_inv_x: float | None = None, w_k: torch.Tensor | None = None,
                 res: torch.Tensor | None = None, rate: float = 1.0,
                 keep_fp32: bool = False):
    """One int8 trunk site, NHWC, through the op ``isr::conv3x3_int8``: fp32
    ``x`` with its scale ``inv_x`` (requantized on load) or int8 ``x`` with
    ``inv_x=None``; with ``res`` (fp32, the output's shape) the epilogue adds
    ``res + y * rate``; fp32 out, or int8 requantized with ``out_inv_x``, or
    the pair (fp32, int8) with ``keep_fp32``. ``w_k``:
    ``weights_k_major(w_q)``, laid out once by the caller; the card needs it,
    the CPU reads ``w_q``. CPU tensors: the plain version. CUDA tensors: the
    hand-written kernel on the current stream, or an error."""
    if (x.dtype == torch.int8) != (inv_x is None):
        raise TypeError("x must be fp32 with its inv_x, or int8 with inv_x=None; got "
                        f"{x.dtype} with inv_x={inv_x}")
    if keep_fp32 and out_inv_x is None:
        raise ValueError("keep_fp32 keeps the fp32 output beside the int8 one: it needs "
                         "out_inv_x")
    _build.check_device(x)
    outs = _conv(x, w_q, deq, bias, bool(leaky), None if inv_x is None else float(inv_x),
                 None if out_inv_x is None else float(out_inv_x), w_k, res, float(rate),
                 bool(keep_fp32))
    return tuple(outs) if keep_fp32 else outs[0]


def _conv_cpu(x, w_q, deq, bias, leaky, inv_x, out_inv_x, w_k, res, rate, keep_fp32):
    out = conv3x3_int8_reference(x, w_q, deq, bias, leaky, inv_x, out_inv_x, res, rate,
                                 keep_fp32)
    return list(out) if keep_fp32 else [out]


def _conv_outputs(x, w_q, deq, bias, leaky, inv_x, out_inv_x, w_k, res, rate,
                  keep_fp32) -> list:
    """The op's outputs, empty (its fake implementation): the fp32 one
    unless only int8 is asked for, then the int8 one if ``out_inv_x``."""
    shape = (*x.shape[:3], w_q.shape[1])
    dtypes = ([torch.float32] if out_inv_x is None or keep_fp32 else []) + (
        [torch.int8] if out_inv_x is not None else [])
    return [torch.empty(shape, dtype=dt, device=x.device) for dt in dtypes]


def _conv_cuda(x, w_q, deq, bias, leaky, inv_x, out_inv_x, w_k, res, rate, keep_fp32):
    """The conv kernel's launch, counted in ``conv3x3_int8.launches`` and by
    variant and epilogue."""
    if x.dtype not in (torch.float32, torch.int8) or w_q.dtype != torch.int8:
        raise TypeError(f"x must be fp32 or int8 and w_q int8, got {x.dtype}, {w_q.dtype}")
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
    if res is not None and (res.dtype != torch.float32 or tuple(res.shape) != (b, h, w, cout)):
        raise ValueError(f"res must be fp32 {(b, h, w, cout)}, got {res.dtype} "
                         f"{tuple(res.shape)}")
    npad = -(-cout // N_TILE) * N_TILE
    if w_k is None:
        raise ValueError(f"the kernel needs w_k = weights_k_major(w_q), ({npad}, {9 * cin}) "
                         f"int8, laid out once by the caller")
    if w_k.dtype != torch.int8 or tuple(w_k.shape) != (npad, 9 * cin):
        raise ValueError(f"w_k must be int8 ({npad}, {9 * cin}), got {w_k.dtype} "
                         f"{tuple(w_k.shape)}")
    _build.check_operands(x, w_q, w_k, deq, bias, res)
    # out of place: the first block's residual is the head's output, which
    # the global skip reads again
    outs = _conv_outputs(x, w_q, deq, bias, leaky, inv_x, out_inv_x, w_k, res, rate, keep_fp32)
    if b * h * w * cout == 0:
        return outs
    out = outs[0] if outs[0].dtype == torch.float32 else None
    out8 = outs[-1] if out_inv_x is not None else None
    plan = conv_plan(b, h, w, cin, cout, _build.sm_count(x.device))

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch(_library(), "isr_conv3x3_int8", x.device, x.data_ptr(), w_k.data_ptr(),
                  deq.data_ptr(), bias.data_ptr(), ptr(res), ptr(out), ptr(out8), b, h, w,
                  cin, cout, int(x.dtype == torch.float32), int(bool(leaky)), LEAKY_SLOPE,
                  float(rate), float(inv_x or 0.0), float(out_inv_x or 0.0), plan["cc"],
                  plan["grid_x"])
    conv3x3_int8.launches += 1
    _count(conv3x3_int8.launches_by_variant,
           conv_variant(x.dtype, torch.float32 if out is not None else torch.int8))
    for epilogue in conv_epilogues(res is not None, out_inv_x is not None):
        _count(conv3x3_int8.launches_by_epilogue, epilogue)
    return outs


_conv = _build.register(
    "conv3x3_int8", "(Tensor x, Tensor w_q, Tensor deq, Tensor bias, bool leaky, "
    "float? inv_x, float? out_inv_x, Tensor? w_k, Tensor? res, float rate, "
    "bool keep_fp32) -> Tensor[]",
    _conv_cpu, _conv_cuda, _conv_outputs)


def _count(counts: dict, key: str) -> None:
    counts[key] = counts.get(key, 0) + 1


def conv_variant(in_dtype: torch.dtype, out_dtype: torch.dtype) -> str:
    """The conv site's variant by its input and (fp32, if it stores one)
    output dtypes, e.g. ``"fp32 -> int8"`` (a conv0 site handing off to its
    conv1)."""
    names = {torch.float32: "fp32", torch.int8: "int8"}
    return f"{names[in_dtype]} -> {names[out_dtype]}"


def conv_epilogues(residual: bool, int8_out: bool) -> tuple:
    """What the conv site's epilogue does beyond dequantizing, as
    ``launches_by_epilogue`` counts it: ``"residual"``, it adds
    ``res + y * rate``; ``"int8 copy"``, it stores that sum in int8 for the
    next site."""
    if not residual:
        return ()
    return ("residual", "int8 copy") if int8_out else ("residual",)


matmul.launches = 0
conv3x3_int8.launches = 0
conv3x3_int8.launches_by_variant = {}  # conv_variant(...) -> launches
conv3x3_int8.launches_by_epilogue = {}  # conv_epilogues(...) entries -> launches
