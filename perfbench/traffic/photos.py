"""Traffic kind ``photos``: one client sends single photos one after
another through ``TiledUpscaler.upscale_image``. Sizes come in blocks of
ten requests holding each size class its share (in tenths), shuffled per
block by the seed, so every seed sends the same mix. Latency is request to
stitched host array, over every photo of the window. Parameters: ``sizes``
([height, width, tenths]), ``photos_per_size``, ``window``, ``overlap``,
``batch``, ``calibration_crops``, ``schedule_blocks``, ``trace_seconds``."""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np
import torch

from perfbench.harness.traffic import Reservoir, Span, no_span, percentile
from perfbench.harness.weights import generator, substream


class Traffic:
    def __init__(self, p: dict, seed: int, device):
        self.sizes = [(h, w) for h, w, _ in p["sizes"]]
        block = [c for c, (_, _, tenths) in enumerate(p["sizes"]) for _ in range(tenths)]
        if len(block) != 10:
            raise ValueError(f"size shares must add up to ten tenths, got {len(block)}")
        self.window_px, self.overlap, self.batch = p["window"], p["overlap"], p["batch"]
        g = generator(seed, 1, device)
        self.photos = [torch.randint(0, 256, (p["photos_per_size"], h, w, 3), dtype=torch.uint8,
                                     generator=g, device=device).cpu().numpy()
                       for h, w in self.sizes]
        rng = np.random.default_rng(substream(seed, 3))
        self.order = rng.permuted(np.tile(block, (p["schedule_blocks"], 1)), axis=1).ravel()
        self.crops, self.seed = p["calibration_crops"], seed

    def calibration(self) -> List[np.ndarray]:
        """Seeded window-sized crops of the photo set, one batch."""
        rng = np.random.default_rng(substream(self.seed, 4))
        crops = []
        for _ in range(self.crops):
            c = int(rng.integers(len(self.photos)))
            img = self.photos[c][int(rng.integers(len(self.photos[c])))]
            y = int(rng.integers(img.shape[0] - self.window_px + 1))
            x = int(rng.integers(img.shape[1] - self.window_px + 1))
            crops.append(img[y:y + self.window_px, x:x + self.window_px])
        return [np.stack(crops)]

    def upscaler(self, deployed):
        from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler

        return TiledUpscaler(deployed, window=self.window_px, overlap=self.overlap,
                             batch_size=self.batch)

    def warm(self, up) -> None:
        for c in range(len(self.sizes)):
            up.upscale_image(self.photos[c][0])

    def window(self, up, seconds: float, span: Span = no_span) -> dict:
        sample = Reservoir(np.random.default_rng(substream(self.seed, 2)))
        counts = [0] * len(self.sizes)
        latencies: List[float] = []
        failed = i = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        pixels = 0
        while time.perf_counter() < deadline:
            c = int(self.order[i % len(self.order)])
            key = (c, counts[c] % len(self.photos[c]))
            counts[c] += 1
            i += 1
            image = self.photos[c][key[1]]
            start = time.perf_counter()
            try:
                with span("photo/request"):
                    out = up.upscale_image(image)
            except Exception as e:  # a failed request is counted, and fails the run
                failed += 1
                print(f"photo {key} failed: {e!r}", file=sys.stderr, flush=True)
                continue
            latencies.append(time.perf_counter() - start)
            pixels += image.shape[0] * image.shape[1]
            sample.offer(c, key, out)
        elapsed = time.perf_counter() - t0
        done = len(latencies)
        metrics = {}
        if done:
            metrics = {"photo_p95_ms": percentile(latencies, 95) * 1e3,
                       "photo_p50_ms": percentile(latencies, 50) * 1e3}
        return {
            "attempted": i, "failed": failed, "elapsed_s": elapsed, "completed": done,
            "input_pixels": pixels, "metrics": metrics,
            "samples": [(self.photos[c][k], out) for (c, k), out in sample.kept.values()],
            "trunk_shape": (self.batch, self.window_px, self.window_px),
        }

    def reference(self, apply, image: np.ndarray, config: dict) -> np.ndarray:
        from perfbench.reference.tiling import upscale

        return upscale(apply, image, self.window_px, self.overlap, self.batch,
                       grid=config.get("downshuffle", 1))
