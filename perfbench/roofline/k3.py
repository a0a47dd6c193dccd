"""K3 (``ops/kernels/channel_attention.ca_residual``,
``csrc/channel_attention.cu``): the end of one RCAB, two passes over NHWC
activations in the stream's dtype. ``r`` (conv1's output) is read by each
pass, ``x`` read and ``x'`` written once. The partial sums, the MLP's
weights and the operations (a few per element) are left out: the bound is
by bytes. The count K3's measurements in PERF.md used, frozen here."""

from __future__ import annotations

BYTES = {"bfloat16": 2, "float32": 4}


def work_bytes(stream: str, b: int, h: int, w: int, c: int) -> int:
    """Device-memory bytes of one block's two passes on a (b, h, w, c)
    stream in ``stream`` ("bfloat16" or "float32")."""
    return b * h * w * c * 4 * BYTES[stream]
