"""K4 (``ops/kernels/flow_warp``, ``csrc/flow_warp.cu``): one flow warp of
NHWC features, bound by device-memory bytes. The feature read once, the
flow (two fp32 a pixel), the frame slot where the propagation fuses it
(``frame`` channels, read and written), and the warped channels written.
The corners' re-reads (each input pixel feeds four outputs) and the few
operations a value are left out: the bound is by bytes."""

from __future__ import annotations


def work_bytes(n: int, h: int, w: int, c: int, frame: int, x_bytes: int, out_bytes: int) -> int:
    """Device-memory bytes of one launch on ``n`` images of h x w with ``c``
    channels (``x_bytes`` an element), a ``frame`` slot of that many
    channels (0 for none) and ``out_bytes`` an output element; the
    arguments are the key of ``flow_warp.launches_by_shape``."""
    return n * h * w * (c * x_bytes + 2 * 4 + frame * out_bytes + (frame + c) * out_bytes)
