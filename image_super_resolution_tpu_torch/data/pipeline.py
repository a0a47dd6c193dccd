"""Training input pipeline (counterpart of the JAX package's
``data/pipeline.py``): host-side decode and crop, device-side degradation.

- Host (``PatchLoader``): decode + random crop, shipping uint8 NHWC
  batches, by one of two backends, chosen as the JAX package chooses
  (``LoaderConfig.backend``): ``"native"``, the C++ loader of ``native/``
  (one call per batch on ``workers`` native threads, JPEGs decoded only
  where the crop lies); ``"python"``, a thread pool over cv2/PIL; and
  ``"auto"`` (the default), native where the library builds and at least
  half the manifest is JPEG or PNG, else python. The choice is printed
  once. Each backend cuts the crops of its JAX counterpart: splitmix64
  offsets seeded from ``SeedSequence([seed, epoch, batch, index])`` in the
  native one, ``np.random.Generator`` from the same seed sequence in the
  Python one. Images smaller than the patch are reflect-padded. A file that
  cannot be decoded becomes a black patch, as in the JAX package, and is
  counted in ``substituted`` (per epoch), which the training CLI prints.
  In data-parallel training each node (a JAX host) loads an equal stripe of
  the manifest, the remainder dropped, and each rank of a node cuts only
  its rows of every node batch: the crops the one-process loader cuts for
  those rows, since a crop is keyed by (seed, epoch, batch, index).
- Transfer (``DevicePrefetcher``): a thread copies each batch from pinned
  memory to the card with ``non_blocking=True`` while the previous step
  runs.
- Device (``make_sr_batch_fn``, ``make_denoise_batch_fn``): downscale or the
  denoise chain, then normalize, in fp32 on the device.
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

from .. import native
from ..core.mesh import broadcast_object
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
    backend: str = "auto"  # "auto", "native" (the C++ loader) or "python"


BACKENDS = ("auto", "native", "python")


class PatchLoader:
    """Epoch-based uint8 patch loader over a manifest: iterating yields
    (B, patch, patch, 3) uint8 arrays, ``len`` full batches per epoch (one,
    filled by cycling the samples, when there are fewer than a batch).

    Data-parallel training: ``process_index`` of ``process_count`` nodes
    loads the node's stripe (JAX's ``PatchLoader(process_index=,
    process_count=)``; ``samples`` is the stripe, ``full_samples`` the
    manifest), and ``local_rank`` of ``local_world`` ranks on the node
    yields rows ``[local_rank * B / local_world, (local_rank + 1) * B /
    local_world)`` of each node batch of ``batch_size`` B."""

    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD

    def __init__(self, manifest: str | Path | Sequence[str], config: LoaderConfig,
                 process_index: int = 0, process_count: int = 1,
                 local_rank: int = 0, local_world: int = 1):
        self.samples = (load_manifest(manifest) if isinstance(manifest, (str, Path))
                        else list(manifest))
        if not self.samples:
            raise ValueError("empty manifest")
        self.full_samples = list(self.samples)
        if process_count > 1:  # equal stripes: every node runs the same steps
            per_node = len(self.samples) // process_count
            if per_node == 0:
                raise ValueError(f"manifest smaller than process_count={process_count}")
            self.samples = self.samples[:per_node * process_count][process_index::process_count]
        if config.batch_size % local_world:
            raise ValueError(f"batch_size {config.batch_size} does not divide over "
                             f"{local_world} ranks")
        rows = config.batch_size // local_world
        self.rows = slice(local_rank * rows, (local_rank + 1) * rows)
        self.config = config
        self.patch = ground_up(config.patch_size, max(config.scale, 1))
        self._epoch = 0
        self._lock = threading.Lock()
        self.substituted = 0  # patches of unreadable files in the last epoch
        self._backend_choice: Optional[str] = None

    def __len__(self) -> int:
        return max(len(self.samples) // self.config.batch_size, 1)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def calculate_stats(self, max_images: int = 512) -> Tuple[list, list]:
        """Dataset mean/std from running sums over up to ``max_images``
        readable images of the whole manifest (not the node's stripe); they
        replace the ImageNet defaults. In data-parallel training rank 0's
        result is every rank's (nodes may read different files)."""
        s, ss, count, skipped = np.zeros(3), np.zeros(3), 0, 0
        for path in self.full_samples[:max_images]:
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
        self.mean, self.std = broadcast_object((self.mean, self.std))
        return list(self.mean), list(self.std)

    def _load_patch(self, path: str, rng: np.random.Generator) -> np.ndarray:
        img = _read_rgb(path)
        if img is None:
            with self._lock:
                self.substituted += 1
            return np.zeros((self.patch, self.patch, 3), np.uint8)
        return _random_crop(img, self.patch, rng)

    def _batch_indices(self, order: np.ndarray, b: int) -> np.ndarray:
        """This rank's rows of node batch ``b``: sample indices."""
        bs = self.config.batch_size
        idx = order[b * bs:(b + 1) * bs]
        if len(idx) < bs:  # fewer samples than a batch: cycle the permutation
            idx = np.concatenate([idx, np.resize(order, bs - len(idx))])
        return idx[self.rows]

    @property
    def backend(self) -> str:
        """The backend batches come from, ``"native"`` or ``"python"``:
        chosen at first use and printed once (``PatchLoader backend:
        <name>``); raises there when ``native`` was asked for and the C++
        loader is unavailable."""
        if self._backend_choice is None:
            self._backend_choice = self._pick_backend()
            print(f"PatchLoader backend: {self._backend_choice}", flush=True)
        return self._backend_choice

    @property
    def uses_native(self) -> bool:
        return self.backend == "native"

    def _pick_backend(self) -> str:
        backend = self.config.backend
        if backend not in BACKENDS:
            raise ValueError(f"LoaderConfig.backend must be one of {BACKENDS}, got {backend!r}")
        if backend == "python":
            return "python"
        ok = native.available()
        if backend == "native":
            if not ok:
                raise RuntimeError(
                    "LoaderConfig.backend='native' but the C++ loader did not build on this "
                    f"host (need g++, libjpeg, libpng): {native.build_error()}")
            return "native"
        # auto: a slot the library cannot decode costs a failed native probe
        # and then a serial Python decode, so mostly-bmp/webp/tiff manifests
        # stay on the Python thread pool.
        if not ok:
            return "python"
        decodable = sum(1 for p in self.samples
                        if str(p).lower().endswith((".jpg", ".jpeg", ".png")))
        return "native" if decodable * 2 >= len(self.samples) else "python"

    def _iter_native(self, order: np.ndarray) -> Iterator[np.ndarray]:
        """One ``native.load_patches`` call per batch on ``workers`` native
        threads, pipelined min(prefetch, 8) batches deep (each batch in
        flight already runs ``workers`` threads)."""
        cfg = self.config

        def load_batch(b: int):
            idx = self._batch_indices(order, b)
            seeds = [int(np.random.SeedSequence([cfg.seed, self._epoch, b, int(i)])
                         .generate_state(1, np.uint64)[0]) for i in idx]
            return native.load_patches([self.samples[i] for i in idx], self.patch, seeds,
                                       threads=max(cfg.workers, 1))

        depth = min(max(cfg.prefetch, 1), 8)
        with ThreadPoolExecutor(max_workers=depth) as pool:
            for fut in _pipelined(lambda b: pool.submit(load_batch, b), len(self), depth):
                batch, substituted = fut.result()
                self.substituted += substituted
                yield batch

    def __iter__(self) -> Iterator[np.ndarray]:
        cfg = self.config
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, self._epoch]))
        order = rng.permutation(len(self.samples))
        self.substituted = 0
        if self.uses_native:
            yield from self._iter_native(order)
            return
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
