"""K1 (``ops/kernels/fused_rdb``, ``csrc/fused_rdb.cu``): one scatter-form
RDB over NHWC bf16 activations, C=64, g=32. Five 3x3 convs; x read and
the output written once, the weights (bf16) and the bias (fp32) read once.
A frozen copy of the builder's count, with the kernel's widths written in."""

from __future__ import annotations

from typing import Tuple

C = 64
G = C // 2
PC = 4 * G + C
CONVS = ((C, PC), (G, PC - G), (G, PC - 2 * G), (G, PC - 3 * G), (G, C))  # (cin, cout)


def work(b: int, h: int, w: int) -> Tuple[int, int]:
    """(FLOP, bytes) of one RDB call on a (b, h, w, C) input."""
    pixels = b * h * w
    flops = 2 * 9 * sum(ci * co for ci, co in CONVS) * pixels
    nbytes = 2 * pixels * C * 2 + sum(9 * ci * co * 2 for ci, co in CONVS) + PC * 4
    return flops, nbytes
