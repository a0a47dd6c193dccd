"""A conv net's operations: each conv counts 2 * k^2 * Cin * Cout per
output position at its own resolution. The conv list is the reference
model's (``reference/<name>.convs``), with each conv's serving precision
(``conv_precisions``)."""

from __future__ import annotations

from typing import Dict, List, Tuple


def ideal_seconds(convs: List[Tuple[str, int, int, int, int]], precisions: Dict[str, str],
                  peaks: Dict[str, float], input_pixels: int) -> float:
    """The time the chip needs for the model's operations on
    ``input_pixels`` input pixels, each conv at the peak of its precision."""
    per_pixel = sum(2 * k * k * ci * co * res * res / peaks[precisions[name]]
                    for name, ci, co, k, res in convs)
    return per_pixel * input_pixels

