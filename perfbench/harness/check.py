"""The correctness check: what the timed path produced, against the plain
reference recomputed from the same weights and inputs.

Both sides are uint8 images. Per sampled output the root mean square of
the difference in 8-bit steps (LSB); over the whole sample, the largest
RMS (``rms_lsb``: a wrong frame, tile or region) and the largest single
difference (``max_lsb``: a pixel altered where it is produced). Each is
held to the cell's limit (``perfbench/cells/<cell>.json``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

Pair = Tuple[np.ndarray, np.ndarray]  # (what the system produced, the reference's)


def compare(pairs: List[Pair]) -> Dict[str, float]:
    rms = worst = 0.0
    for got, want in pairs:
        if got.shape != want.shape:  # as far off as 8-bit images can be
            return {"rms_lsb": 255.0, "max_lsb": 255.0}
        d = got.astype(np.float64) - want.astype(np.float64)
        rms = max(rms, float(np.sqrt(np.mean(d * d))))
        worst = max(worst, float(np.abs(d).max()))
    return {"rms_lsb": rms, "max_lsb": worst}


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)

