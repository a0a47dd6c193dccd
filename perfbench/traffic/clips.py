"""Traffic kind ``clips``: bulk video through a recurrent model, one stream
cut into segments of ``segment`` consecutive frames (BasicSR's
``inference_basicvsr.py --interval``), each segment one call of the model.
The ``frames`` kind's closed loop over a pool of seeded segments in host
memory (``cli/rs.video_pipeline``, the next segment submitted as soon as
the pipeline takes it), with two differences: a sample is keyed by (pool
segment, frame position), one per position, and the reference recomputes
the whole segment (once per segment, cached) and takes the frame, since
each output frame depends on every frame of its segment. Parameters:
``height``, ``width``, ``segment``, ``pool_segments``, ``warmup_segments``,
``trace_seconds``.

The comparison is in units of each frame's rounding noise. With seeded
weights a recurrent model amplifies rounding by a factor that varies from
seed to seed (a bfloat16 program's frames 0.12-2.96 LSB RMS off float32 on
the card), so no limit in 8-bit steps lies both above every seed's
bfloat16 error and below every seed's float8 one. The reference computes
each sampled segment in float32 and as the bfloat16 model (its
``rounded``); a frame's noise is the RMS difference of the two (at least
``NOISE_FLOOR_LSB``). The sample's key carries the program's frame, and
``reference`` computes the comparison itself: the program's difference
from the float32 frame over that noise, as the RMS of each ``BLOCK`` x
``BLOCK``-pixel region, weighted so that their mean square is the frame's.
The sample is zeros of that shape, so the check's ``rms_lsb`` reads the
frame's RMS in noise units (about 1 for a bfloat16 program, several for a
float8 one) and ``max_lsb`` the largest region's: a region computed wrong,
or one value altered by some tens of noise units, where a single pixel's
difference would follow the tail of the rounding itself."""

from __future__ import annotations

import numpy as np

from perfbench.harness.spec import load_kind
from perfbench.harness.traffic import Span, no_span

frames = load_kind("frames")

NOISE_FLOOR_LSB = 0.1  # a frame whose two references agree closer is held to this
BLOCK = 24  # pixels a side of the regions ``max_lsb`` reads (1080 and 1920 are multiples)


def region_rms(d: np.ndarray) -> np.ndarray:
    """(H, W, C) -> the RMS of each ``BLOCK`` x ``BLOCK`` region (partial
    at the right and bottom edges), weighted so that the mean of their
    squares is the mean square of ``d``."""
    h, w = d.shape[:2]
    sums = np.add.reduceat(np.add.reduceat((d * d).sum(-1), np.arange(0, h, BLOCK), 0),
                           np.arange(0, w, BLOCK), 1)
    return np.sqrt(sums * (sums.size / d.size))


class Traffic(frames.Traffic):
    def __init__(self, p: dict, seed: int, device):
        super().__init__({**p, "batch": p["segment"], "pool_batches": p["pool_segments"],
                          "warmup_batches": p["warmup_segments"]}, seed, device)
        self._segments = {}

    def frame(self, i: int):
        """The key of the i-th frame written: (pool segment, position)."""
        return (i // self.batch) % len(self.pool), i % self.batch

    def window(self, up, seconds: float, span: Span = no_span) -> dict:
        w = super().window(up, seconds, span)
        w["samples"] = [((*key, got), np.zeros((-(-got.shape[0] // BLOCK),
                                                -(-got.shape[1] // BLOCK))))
                        for key, got in w["samples"]]
        return w

    def reference(self, apply, key, config: dict) -> np.ndarray:
        """Minus the program's regions' RMS difference from the float32
        frame, in noise units: the sample (zeros) less this is the
        comparison."""
        segment, position, got = key
        if segment not in self._segments:
            plain = apply(self.pool[segment]).astype(np.float64)
            rounded = apply.rounded(self.pool[segment]).astype(np.float64)
            noise = np.sqrt(np.mean((rounded - plain) ** 2, axis=(1, 2, 3)))
            self._segments[segment] = plain, np.maximum(noise, NOISE_FLOOR_LSB)
        plain, noise = self._segments[segment]
        want = plain[position]
        if got.shape != want.shape:  # as far off as 8-bit frames can be
            return np.full((-(-got.shape[0] // BLOCK), -(-got.shape[1] // BLOCK)), -255.0)
        return -region_rms((got.astype(np.float64) - want) / noise[position])
