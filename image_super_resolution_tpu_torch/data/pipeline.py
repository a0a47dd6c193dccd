"""Training input pipeline (counterpart of the JAX package's
``data/pipeline.py``): host-side decode and crop, device-side degradation.

- Host (``PatchLoader``): decode + random crop on a thread pool, shipping
  uint8 NHWC batches. Each patch's crop comes from
  ``SeedSequence([seed, epoch, batch, index])``, as in the JAX package's
  Python backend, so the two packages cut the same patches. Images smaller
  than the patch are reflect-padded. A file that cannot be decoded becomes
  a black patch, as in the JAX package, and is counted in ``substituted``
  (per epoch), which the training CLI prints.
- Transfer (``DevicePrefetcher``): a thread copies each batch from pinned
  memory to the card with ``non_blocking=True`` while the previous step
  runs.
- Device (``make_sr_batch_fn``, ``make_denoise_batch_fn``): downscale or the
  denoise chain, then normalize, in fp32 on the device.

The C++ loader (``--loader_backend native``) comes with slice 5.
"""

from __future__ import annotations

import queue
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.general import ground_up
from ..utils.image_io import read_image_rgb
from . import degrade
from .manifest import load_manifest
from .transforms import IMAGENET_MEAN, IMAGENET_STD, normalize, to_tanh


def _read_rgb(path: str) -> Optional[np.ndarray]:
    """Decode to RGB HWC uint8; None when no decoder reads the file."""
    try:
        return read_image_rgb(path)
    except Exception:  # any decoder's failure: the caller substitutes a patch
        return None


def _random_crop(img: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    h, w = img.shape[:2]
    if h < size or w < size:
        img = np.pad(img, ((0, max(0, size - h)), (0, max(0, size - w)), (0, 0)),
                     mode="reflect")
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top:top + size, left:left + size]


def _pipelined(submit, n_batches: int, depth: int):
    """Keep up to ``depth`` submitted batches in flight, yielding in order."""
    pending = deque(submit(b) for b in range(min(max(depth, 1), n_batches)))
    next_b = len(pending)
    for _ in range(n_batches):
        item = pending.popleft()
        yield item
        if next_b < n_batches:
            pending.append(submit(next_b))
            next_b += 1


@dataclass
class LoaderConfig:
    batch_size: int = 16
    patch_size: int = 96
    scale: int = 2
    workers: int = 4
    seed: int = 100
    prefetch: int = 4


class PatchLoader:
    """Epoch-based uint8 patch loader over a manifest: iterating yields
    (B, patch, patch, 3) uint8 arrays, ``len`` full batches per epoch (one,
    filled by cycling the samples, when there are fewer than a batch)."""

    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD

    def __init__(self, manifest: str | Path | Sequence[str], config: LoaderConfig):
        self.samples = (load_manifest(manifest) if isinstance(manifest, (str, Path))
                        else list(manifest))
        if not self.samples:
            raise ValueError("empty manifest")
        self.config = config
        self.patch = ground_up(config.patch_size, max(config.scale, 1))
        self._epoch = 0
        self._lock = threading.Lock()
        self.substituted = 0  # patches of unreadable files in the last epoch

    def __len__(self) -> int:
        return max(len(self.samples) // self.config.batch_size, 1)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def calculate_stats(self, max_images: int = 512) -> Tuple[list, list]:
        """Dataset mean/std from running sums over up to ``max_images``
        readable images; they replace the ImageNet defaults."""
        s, ss, count, skipped = np.zeros(3), np.zeros(3), 0, 0
        for path in self.samples[:max_images]:
            img = _read_rgb(path)
            if img is None:
                skipped += 1
                continue
            x = img.reshape(-1, 3).astype(np.float64) / 255.0
            s += x.sum(0)
            ss += (x ** 2).sum(0)
            count += x.shape[0]
        if skipped:
            warnings.warn(f"calculate_stats skipped {skipped} unreadable manifest "
                          "image(s); stats computed from the readable remainder")
        if count:
            mean = s / count
            self.mean = tuple(float(v) for v in mean)
            self.std = tuple(float(v) for v in np.sqrt(np.maximum(ss / count - mean ** 2,
                                                                  1e-12)))
        return list(self.mean), list(self.std)

    def _load_patch(self, path: str, rng: np.random.Generator) -> np.ndarray:
        img = _read_rgb(path)
        if img is None:
            with self._lock:
                self.substituted += 1
            return np.zeros((self.patch, self.patch, 3), np.uint8)
        return _random_crop(img, self.patch, rng)

    def _batch_indices(self, order: np.ndarray, b: int) -> np.ndarray:
        bs = self.config.batch_size
        idx = order[b * bs:(b + 1) * bs]
        if len(idx) < bs:  # fewer samples than a batch: cycle the permutation
            idx = np.concatenate([idx, np.resize(order, bs - len(idx))])
        return idx

    def __iter__(self) -> Iterator[np.ndarray]:
        cfg = self.config
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, self._epoch]))
        order = rng.permutation(len(self.samples))
        self.substituted = 0
        with ThreadPoolExecutor(max_workers=max(cfg.workers, 1)) as pool:
            def submit_batch(b: int):
                return [pool.submit(self._load_patch, self.samples[i], np.random.default_rng(
                            np.random.SeedSequence([cfg.seed, self._epoch, b, int(i)])))
                        for i in self._batch_indices(order, b)]

            for futures in _pipelined(submit_batch, len(self), cfg.prefetch):
                yield np.stack([f.result() for f in futures])


def make_sr_batch_fn(
    scale: int,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    hr_mode: str = "tanh",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """uint8 crops on the device -> (hr, lr): LR = normalize(downscale(x));
    HR = tanh(x) in [-1, 1] (``hr_mode="tanh"``, the pixel phase) or
    normalize(x) (``"norm"``, the GAN phase)."""
    if hr_mode not in ("tanh", "norm"):
        raise ValueError(f"hr_mode must be 'tanh' or 'norm', got {hr_mode!r}")

    def fn(u8: torch.Tensor):
        x01 = u8.float() / 255.0
        hr = to_tanh(x01) if hr_mode == "tanh" else normalize(x01, mean, std)
        return hr, normalize(degrade.downscale(x01, scale), mean, std)

    return fn


def make_denoise_batch_fn(
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    degradation: Callable = degrade.denoise_degradation,
) -> Callable[[torch.Tensor, torch.Generator], Tuple[torch.Tensor, torch.Tensor]]:
    """uint8 crops on the device -> (hr, lr): LR =
    normalize(jpeg(iso(gauss(x)))) drawn from ``gen``, HR = tanh(x)."""

    def fn(u8: torch.Tensor, gen: torch.Generator):
        x01 = u8.float() / 255.0
        return to_tanh(x01), normalize(degradation(gen, x01), mean, std)

    return fn


class DevicePrefetcher:
    """Copies ``depth`` uint8 batches ahead to ``device`` on a thread: from
    pinned memory with ``non_blocking=True`` on the card, while the previous
    step runs. Use as a context manager: leaving it stops the thread, also
    when a step raises."""

    def __init__(self, it: Iterator[np.ndarray], device: torch.device, depth: int = 2):
        self._it = iter(it)
        self._device = device
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._exc: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """A bounded put that gives up once ``close`` was called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                t = torch.from_numpy(np.ascontiguousarray(batch))
                if self._device.type == "cuda":
                    t = t.pin_memory().to(self._device, non_blocking=True)
                if not self._put(t):
                    return
        except BaseException as e:  # handed to the consumer, never swallowed
            self._exc = e
        finally:
            self._put(self._done)

    def close(self) -> None:
        self._stop.set()
        while True:  # drain so a put-blocked producer sees the stop
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise RuntimeError("DevicePrefetcher producer thread failed; the "
                                   "training input stream is broken") from exc
            raise StopIteration
        return item
