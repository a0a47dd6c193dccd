"""Traffic kind ``frames``: bulk video. One decoder stand-in feeds frame
batches from a pool of seeded batches in host memory through
``cli/rs.video_pipeline`` until the deadline, then the pipeline drains.
Throughput is the output pixels of every frame handed to the writer over
the whole window (first submit to last frame written). Parameters:
``height``, ``width``, ``batch``, ``pool_batches``, ``warmup_batches``,
``trace_seconds``."""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from perfbench.harness.traffic import Reservoir, Span, no_span
from perfbench.harness.weights import generator, substream


class Traffic:
    def __init__(self, p: dict, seed: int, device):
        self.batch, self.height, self.width = p["batch"], p["height"], p["width"]
        shape = (p["pool_batches"], self.batch, self.height, self.width, 3)
        pool = torch.randint(0, 256, shape, dtype=torch.uint8,
                             generator=generator(seed, 1, device), device=device)
        self.pool = pool.cpu().numpy()  # host memory, as a decoder would hand it over
        self.warmup_batches = p["warmup_batches"]
        self.seed = seed

    def calibration(self) -> List[np.ndarray]:
        return [self.pool[0]]

    def upscaler(self, deployed):
        from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler

        return TiledUpscaler(deployed)

    def _run(self, up, batches, write) -> int:
        from image_super_resolution_tpu_torch.cli.rs import video_pipeline

        return video_pipeline(up, batches, write)

    def warm(self, up) -> None:
        self._run(up, ((self.pool[k % len(self.pool)], self.batch)
                       for k in range(self.warmup_batches)), lambda frame: None)

    def window(self, up, seconds: float, span: Span = no_span) -> dict:
        sample = Reservoir(np.random.default_rng(substream(self.seed, 2)))
        submitted = written = 0

        def batches():
            nonlocal submitted
            while time.perf_counter() < deadline:
                yield self.pool[submitted % len(self.pool)], self.batch
                submitted += 1

        def write(frame):
            nonlocal written
            sample.offer(written % self.batch, written, frame)
            written += 1

        t0 = time.perf_counter()
        deadline = t0 + seconds
        self._run(up, batches(), write)
        elapsed = time.perf_counter() - t0
        s = up.deployed.spec.output_scale
        out_pixels = written * self.height * s * self.width * s
        return {
            "attempted": submitted * self.batch, "failed": submitted * self.batch - written,
            "elapsed_s": elapsed, "completed": written, "input_pixels": written * self.height * self.width,
            "metrics": {"out_mpix_per_s": out_pixels / 1e6 / elapsed},
            "samples": [(self.frame(i), out) for i, out in sample.kept.values()],
            "trunk_shape": (self.batch, self.height, self.width),
        }

    def frame(self, i: int) -> np.ndarray:
        """The input of the i-th frame written."""
        return self.pool[(i // self.batch) % len(self.pool)][i % self.batch]

    @staticmethod
    def reference(apply, image: np.ndarray, config: dict) -> np.ndarray:
        return apply(image[None])[0]
