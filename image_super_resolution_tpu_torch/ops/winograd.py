"""Winograd F(m, 3) convolution for the 3x3 trunk convs (counterpart of the
JAX package's ``ops/winograd.py``).

F(m, 3) computes an m x m output tile of a 3x3 convolution with (m+2)^2
multiplies instead of 9 m^2:

    F(2,3): 16/36  = 2.25x fewer multiplies
    F(4,3): 36/144 = 4.00x fewer (larger, less accurate transforms)

Y = A^T [ (G g G^T) .* (B^T d B) ] A, per tile: the kernel transform runs
once, when the weights are loaded (``transform_kernel``); per call the input
tiles are transformed, multiplied by the kernel in one batched matrix product
over the t^2 tile positions (t = m + 2), and transformed back.

Numerics follow the JAX function: pad and input transform in fp32; the
products take operands cast to the compute ``dtype`` and sum in fp32; the
inverse transform and the bias in fp32; the output cast to the input's
dtype. A bf16 ``torch.bmm`` would round its sums to bf16 before the inverse
transform, where JAX's ``preferred_element_type=float32`` does not, so the
product here keeps fp32 sums: on a CUDA tensor through ``bmm``'s fp32
``out_dtype``, on the CPU as an fp32 product of the bf16-rounded operands
(products of bf16 values are exact in fp32). F(4,3) amplifies operand
rounding about ten-fold in bf16 and is meant for fp32 only, as in JAX.

Plain PyTorch on every device: the JAX package computes this in XLA, not in
a Pallas kernel. Reference: Lavin & Gray, "Fast Algorithms for Convolutional
Neural Networks" (arXiv:1509.09308).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# F(2x2, 3x3): B^T, G, A^T
_BT2 = [[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]]
_G2 = [[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]]
_AT2 = [[1, 1, 1, 0], [0, 1, -1, -1]]

# F(4x4, 3x3) (Lavin & Gray / NNPACK coefficients)
_BT4 = [
    [4, 0, -5, 0, 1, 0],
    [0, -4, -4, 1, 1, 0],
    [0, 4, -4, -1, 1, 0],
    [0, -2, -1, 2, 1, 0],
    [0, 2, -1, -2, 1, 0],
    [0, 4, 0, -5, 0, 1],
]
_G4 = [
    [1 / 4, 0, 0],
    [-1 / 6, -1 / 6, -1 / 6],
    [-1 / 6, 1 / 6, -1 / 6],
    [1 / 24, 1 / 12, 1 / 6],
    [1 / 24, -1 / 12, 1 / 6],
    [0, 0, 1],
]
_AT4 = [
    [1, 1, 1, 1, 1, 0],
    [0, 1, -1, 2, -2, 0],
    [0, 1, 1, 4, 4, 0],
    [0, 1, -1, 8, -8, 1],
]

_TRANSFORMS = {m: tuple(np.array(a, np.float32) for a in mats)
               for m, mats in ((2, (_BT2, _G2, _AT2)), (4, (_BT4, _G4, _AT4)))}


def _matrix(m: int, which: int, device) -> torch.Tensor:
    if m not in _TRANSFORMS:
        raise ValueError(f"Winograd F(m, 3) is defined for m = 2 or 4, got {m}")
    return torch.from_numpy(_TRANSFORMS[m][which]).to(device)


def transform_kernel(w_hwio, m: int = 2) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (t, t, Cin, Cout) Winograd-domain kernel, fp32:
    G w G^T. A weight transform: run it once, when the weights are loaded."""
    w = torch.as_tensor(np.asarray(w_hwio, np.float32)) if not torch.is_tensor(w_hwio) \
        else w_hwio.float()
    g = _matrix(m, 1, w.device)
    return (g @ w.permute(2, 3, 0, 1) @ g.T).permute(2, 3, 0, 1).contiguous()


def _products(d: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """(P, N, Cin) x (P, Cin, Cout) -> fp32 (P, N, Cout): operands in
    ``dtype``, sums in fp32."""
    if d.is_cuda and dtype != torch.float32:
        return torch.bmm(d.to(dtype), w.to(dtype), out_dtype=torch.float32)
    return torch.bmm(d.to(dtype).float(), w.to(dtype).float())


def winograd_conv3x3(x: torch.Tensor, w_wino: torch.Tensor,
                     b: Optional[torch.Tensor] = None, m: int = 2,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """'SAME' 3x3 convolution of NHWC ``x`` with a Winograd-domain kernel
    ``w_wino = transform_kernel(w, m)``, (t, t, Cin, Cout) or its (t*t*Cin,
    Cout) flattening. Equal to ``direct_conv3x3(x, w, b)`` up to float
    reassociation and the operands' rounding to ``dtype``."""
    bt, at = _matrix(m, 0, x.device), _matrix(m, 2, x.device)
    t = m + 2
    n, h, w_, c = x.shape
    nh, nw = -(-h // m), -(-w_ // m)
    # 'SAME' for 3x3 is a 1-pixel halo; pad bottom/right so whole tiles cover
    xp = F.pad(x.float(), (0, 0, 1, nw * m + 1 - w_, 1, nh * m + 1 - h))
    # tile (i, j) covers padded rows [i*m, i*m + t) and columns [j*m, j*m + t)
    d = xp.unfold(1, t, m).unfold(2, t, m)  # (N, nh, nw, C, t, t)
    _, th, tw = d.shape[:3]
    # both transforms as one matrix product each over all tiles and
    # channels: B^T d B is kron(B^T, B^T) times d flattened over (t, t)
    d_t = torch.kron(bt, bt) @ d.reshape(-1, t * t).T  # (t*t, N*nh*nw*C)
    prod = _products(d_t.reshape(t * t, -1, c), w_wino.reshape(t * t, c, -1), dtype)
    k = prod.shape[-1]
    y = torch.kron(at, at) @ prod.reshape(t * t, -1)  # A^T M A: (m*m, N*nh*nw*Cout)
    y = y.reshape(m, m, n, th, tw, k).permute(2, 3, 0, 4, 1, 5)
    y = y.reshape(n, th * m, tw * m, k)[:, :h, :w_]
    if b is not None:
        y = y + b.float().reshape(-1)
    return y.to(x.dtype)


def direct_conv3x3(x: torch.Tensor, w_hwio: torch.Tensor,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The direct 'SAME' 3x3 conv with the same signature, fp32 sums (for
    tests and benches)."""
    k = w_hwio.to(x.dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)
