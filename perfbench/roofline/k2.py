"""K2's conv site (``ops/kernels/matmul.conv3x3_int8``, ``csrc/matmul.cu``):
an int8 3x3 conv, NHWC, as an implicit GEMM. Its input is the fp32 stream
(requantized as it loads) or int8; its output fp32 or int8. Each byte of
input and output counted once, the K-major weights (Cout padded to 128)
and the fp32 dequantization and bias read once. A frozen copy of the
builder's count."""

from __future__ import annotations

from typing import Tuple

N_TILE = 128
BYTES = {"fp32": 4, "int8": 1}


def work(variant: str, b: int, h: int, w: int, cin: int, cout: int) -> Tuple[int, int]:
    """(int8 OP, bytes) of one call; ``variant`` as the port names it,
    ``"<in> -> <out>"`` with fp32 or int8 on each side."""
    src, dst = (s.strip() for s in variant.split("->"))
    m = b * h * w
    npad = -(-cout // N_TILE) * N_TILE
    ops = 2 * m * 9 * cin * cout
    nbytes = m * cin * BYTES[src] + npad * 9 * cin + 8 * cout + m * cout * BYTES[dst]
    return ops, nbytes
