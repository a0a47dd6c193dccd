"""K3 (``csrc/channel_attention.cu``): the end of RCAN's residual channel
attention block (``models/rcan.py``), and its plain version.

A port kernel with no TPU counterpart: the JAX package has no RCAN. It was
added because eager PyTorch spends about a dozen elementwise passes over
the block's tensors on what follows its second conv (the bias, the global
average pool, the channel multiply, the residual add), as much device time
as the two convs themselves. After conv1 gives ``r`` (in the stream's
dtype, bf16 on the card; its bias not yet added), with ``b`` conv1's
bias:

    m = mean over H*W of (r + b)                 per image and channel, fp32
    s = sigmoid(W2 relu(W1 m + b1) + b2)         the CA MLP, C -> C/16 -> C, fp32
    x' = x + (r + b) * s                         in the stream's precision

Two launches per block, both bound by device-memory bytes:

- ``reduce``: each CTA sums ``r`` over a contiguous chunk of one image's
  pixels in fp32 and writes its C partial sums; no atomics.
- ``scale``: each CTA first adds up its image's partials in a fixed order
  (so the result is deterministic), divides by H*W and adds ``b`` (the
  bias folded in analytically), runs the tiny MLP itself, then streams its
  pixels and writes ``x'``.

``ca_residual`` is the wrapper, through the op ``isr::ca_residual``: CPU
tensors take the plain version, CUDA tensors the kernel (or an error). It
counts its launches by pass in ``ca_residual.launches_by_pass``
(``"reduce"``, ``"scale"``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

THREADS = 256  # per CTA, both passes (csrc/channel_attention.cu)
VEC = 8  # channels a thread loads at once (16 bytes of bf16)
MAX_HIDDEN = 16  # largest C / reduction the kernel takes
SCALE_PIXELS = 1024  # pixels a scale CTA streams
MAX_CHUNKS = 64  # most partial sums per image and channel
# Kernel vs plain version: each sums the mean in another order (fp32 over up
# to H*W terms), so s differs by a few fp32 ulps, and the product and sums
# are rounded at the same places: |got - want| <= ATOL + RTOL * |want|, with
# RTOL a few fp32 ulps for an fp32 stream, and for a bf16 one one bf16 ulp,
# at most 2^-7 of the value: a rounding flipped by the ulps of s.
KERNEL_RTOL = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -7}
KERNEL_ATOL = 2.0 ** -16


def channel_mean(r: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C) fp32: the mean over H*W of ``r + bias``."""
    return r.float().mean((1, 2)) + bias.float()


def channel_scale(mean: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The CA MLP in fp32: (B, C) -> (B, C), ``sigmoid(W2 relu(W1 m + b1) + b2)``
    with ``w1`` (C/r, C) and ``w2`` (C, C/r), the 1x1 convs' kernels."""
    h = torch.relu(mean @ w1.float().t() + b1.float())
    return torch.sigmoid(h @ w2.float().t() + b2.float())


def ca_residual_reference(x, r, bias, w1, b1, w2, b2):
    """Plain version of the two passes: ``x + (r + bias) * s`` in fp32,
    rounded once to ``x``'s dtype."""
    s = channel_scale(channel_mean(r, bias), w1, b1, w2, b2)
    y = x.float() + (r.float() + bias.float()) * s[:, None, None, :]
    return y.to(x.dtype)


def reduce_chunks(b: int, hw: int, sms: int) -> int:
    """Reduce CTAs per image: enough for about four per SM over the batch,
    each at least ``SCALE_PIXELS`` pixels, at most ``MAX_CHUNKS``."""
    return max(1, min(MAX_CHUNKS, -(-4 * sms // max(b, 1)), -(-hw // SCALE_PIXELS)))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("channel_attention")
    lib.isr_ca_residual.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.isr_ca_residual.restype = ctypes.c_int
    lib.isr_ca_constants.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.isr_ca_constants.restype = None
    got = (ctypes.c_int * 5)()
    lib.isr_ca_constants(got)
    want = (THREADS, VEC, SCALE_PIXELS, MAX_CHUNKS, MAX_HIDDEN)
    if tuple(got) != want:
        raise RuntimeError(f"the kernel's (THREADS, VEC, SCALE_PIXELS, MAX_CHUNKS, MAX_HIDDEN) "
                           f"= {tuple(got)} are not the wrapper's {want}")
    return lib


def ca_residual(x: torch.Tensor, r: torch.Tensor, bias: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``x + (r + bias) * s``, NHWC, with ``s`` the CA MLP of the mean of
    ``r + bias`` over each image. ``x`` (the stream) and ``r`` (conv1's
    output before its bias) in one dtype, fp32 or bf16; the rest fp32:
    ``bias`` (C,), ``w1`` (C/r, C), ``b1`` (C/r,), ``w2`` (C, C/r), ``b2``
    (C,). Returns ``x'`` in ``x``'s dtype. On the card: C a power of two
    from 8 to 256, C/r at most ``MAX_HIDDEN``."""
    _build.check_device(x)
    return _op(x, r, bias, w1, b1, w2, b2)


def _cuda_forward(x, r, bias, w1, b1, w2, b2) -> torch.Tensor:
    """Both passes, counted in ``ca_residual.launches_by_pass``."""
    if x.dim() != 4 or r.shape != x.shape or r.dtype != x.dtype:
        raise ValueError(f"x and r must be one (B, H, W, C) shape and dtype, got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(r.shape)} {r.dtype}")
    b, h, w, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x and r must be fp32 or bf16, got {x.dtype}")
    if c < VEC or c > THREADS or c & (c - 1):
        raise ValueError(f"the kernel needs C a power of two from {VEC} to {THREADS}, got {c}")
    hidden = w1.shape[0]
    want = {"bias": (c,), "w1": (hidden, c), "b1": (hidden,), "w2": (c, hidden), "b2": (c,)}
    params = {"bias": bias, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    for name, t in params.items():
        if t.dtype != torch.float32 or tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be fp32 {want[name]}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"the kernel takes C/r from 1 to {MAX_HIDDEN}, got {hidden}")
    _build.check_operands(x, r, *params.values())
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    chunks = reduce_chunks(b, h * w, _build.sm_count(x.device))
    partials = torch.empty((b, chunks, c), dtype=torch.float32, device=x.device)
    _build.launch(_library(), "isr_ca_residual", x.device, x.data_ptr(), r.data_ptr(),
                  bias.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                  partials.data_ptr(), out.data_ptr(), b, h * w, c, hidden,
                  int(x.dtype == torch.float32), chunks)
    for name in ("reduce", "scale"):
        ca_residual.launches_by_pass[name] = ca_residual.launches_by_pass.get(name, 0) + 1
    return out


_op = _build.register(
    "ca_residual", "(Tensor x, Tensor r, Tensor bias, Tensor w1, Tensor b1, Tensor w2, "
    "Tensor b2) -> Tensor", ca_residual_reference, _cuda_forward,
    lambda x, *args: torch.empty_like(x))

ca_residual.launches_by_pass = {}  # "reduce" / "scale" -> launches
