"""Published dense peaks (NVIDIA data sheets, no sparsity), at the card's
full power limit, by product name: the first row whose name the card's
name contains. A card set below its limit reads lower shares against
these; the runs print the limit beside every share."""

from __future__ import annotations

from typing import Dict, Tuple

# name, bf16 FLOP/s, int8 OP/s (fp8 the same), device-memory bytes/s
PEAKS = (
    ("H100 PCIe", 756e12, 1513e12, 2.0e12),
    ("H100 NVL", 835e12, 1671e12, 3.9e12),
    ("H200", 989e12, 1979e12, 4.8e12),
    ("H100", 989e12, 1979e12, 3.35e12),
)


def peaks(device_name: str) -> Dict[str, float]:
    """{"bfloat16", "int8", "bytes"} per second; the H100 SXM's when no row
    matches."""
    row = next((r for r in PEAKS if r[0] in device_name), PEAKS[-1])
    return {"product": row[0], "bfloat16": row[1], "int8": row[2], "bytes": row[3]}


def bound_s(ops: float, nbytes: float, peak_ops: float, peak_bytes: float) -> Tuple[float, str]:
    """The least time for the work: the larger of operations over the peak
    rate and bytes over the bandwidth, and which of the two it is."""
    t_ops, t_bytes = ops / peak_ops, nbytes / peak_bytes
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
