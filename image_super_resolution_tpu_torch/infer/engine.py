"""Batched tiled inference engine over a deployed model (counterpart of the
JAX package's ``infer/engine.py``).

Tiles are batched, stitched with overlap cropping (``infer/tiling.py``),
and optionally sharded over several devices: by batch (``data_devices``:
tile and frame batches split across devices) or by image rows or a grid
with halo exchange (``spatial_devices``, ``spatial_grid``:
``parallel/spatial.py``) for single huge images. Each sharded path runs a
replica of the model per device (``core.mesh.replicate``). A model whose
blocks average over the whole image (``global_pool``: ``rcan``'s channel
attention) refuses the spatial paths: a band is no whole input (a tile
is: the tiled path averages per tile, as every tiled RCAN deployment
does). A sequence model (``sequence``: ``basicvsr``, whose batch axis is
time) takes whole segments of frames through ``upscale_batch_device``,
their valid frames only, and refuses tiles, bands and data shards, each
of which would cut a segment apart.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.mesh import (local_devices, make_mesh, make_spatial_mesh, replicate,
                         serving_devices, split_batch)
from ..models.deploy import DeployedModel
from ..utils.profiling import annotate
from .tiling import fetch, upscale_tiled


def _check_reflect_fit(dims, pads, grid_desc: str, halo: int) -> None:
    """np.pad(mode='reflect') requires pad <= dim-1; images small relative
    to the device grid and halo would otherwise fail deep inside numpy."""
    for size, pad in zip(dims, pads):
        if pad > size - 1:
            overlap_hint = (
                " or a smaller --overlap" if halo > 8 else
                " (the halo is floored at 8 px, so --overlap cannot go lower)"
            )
            raise ValueError(
                f"image dimension {size} px is too small for {grid_desc} with "
                f"halo {halo} (needs {pad} px of reflect padding, max is "
                f"{size - 1}); use fewer spatial devices{overlap_hint}, or "
                f"the tiled/data-axis path for small images"
            )


class TiledUpscaler:
    def __init__(
        self,
        deployed: DeployedModel,
        window: int = 96,
        overlap: int = 8,
        batch_size: int = 8,
        spatial_devices: int = 1,
        data_devices: int = 1,
        spatial_grid=None,
        devices=None,
    ):
        """window=0 selects whole-image (untiled) inference.

        ``data_devices > 1`` splits every tile batch (``upscale_image``)
        and frame batch (``upscale_batch``) across devices; 0 means all of
        them. ``spatial_devices`` cuts ONE image into row bands with halo
        exchange, ``spatial_grid=(ny, nx)`` into a device grid with halo
        exchange in both dimensions. The three are mutually exclusive.

        The devices are the first N of ``devices``, by default the local
        ones of the model's device type: every card on CUDA (asking for
        more raises), and on the CPU the one CPU standing for every shard.
        Pass ``devices`` to choose them, a card repeated included.
        """
        self.deployed = deployed
        self.window = window
        self.overlap = overlap
        self.batch_size = batch_size
        self.spatial_devices = spatial_devices
        self.spatial_grid = tuple(spatial_grid) if spatial_grid else None
        # Geometry that plan_tiles would reject deep inside upscale_image
        # fails here, at construction, where the CLI turns it into a clean
        # one-line exit.
        if self.overlap < 0:
            raise ValueError(f"overlap must be >= 0, got {self.overlap}")
        if self.window and self.overlap * 2 >= self.window:
            raise ValueError(
                f"need overlap < window/2, got {self.overlap}/{self.window}"
            )
        # downshuffle>1 models are translation-variant with period f: tiles
        # must start on the model's space_to_depth grid, and spatial band
        # offsets cannot be kept on it at all.
        self._grid = getattr(getattr(deployed, "spec", None),
                             "downshuffle", 1) or 1
        if self._grid > 1:
            if spatial_devices > 1 or self.spatial_grid not in (None, (1, 1)):
                raise ValueError(
                    "spatial sharding cannot serve a downshuffle>1 artifact "
                    "(denoise_fast): band offsets shift the model's "
                    "space_to_depth grid; use data_devices instead"
                )
            if self.window and self.window % self._grid:
                raise ValueError(
                    f"window {self.window} must be a multiple of the "
                    f"artifact's downshuffle factor {self._grid} so tiles "
                    f"stay on the model's space_to_depth grid"
                )
            if self.overlap % self._grid:
                raise ValueError(
                    f"overlap {self.overlap} must be a multiple of the "
                    f"artifact's downshuffle factor {self._grid} so tiles "
                    f"stay on the model's space_to_depth grid"
                )
        if getattr(getattr(deployed, "model", None), "global_pool", False) and (
                spatial_devices > 1 or self.spatial_grid not in (None, (1, 1))):
            raise ValueError(
                f"spatial sharding cannot serve a {deployed.spec.family} artifact: "
                f"its blocks average over the whole image, and each band "
                f"would average over itself alone; use data_devices or tiles"
            )
        self._sequence = getattr(getattr(deployed, "model", None), "sequence", False)
        if self._sequence and (spatial_devices != 1 or data_devices != 1
                               or self.spatial_grid not in (None, (1, 1))):
            raise ValueError(
                f"a {deployed.spec.family} artifact is a sequence model: each "
                f"output frame depends on its whole segment, and spatial or "
                f"data sharding would cut a segment apart; serve it on one device"
            )
        if self.spatial_grid:
            if min(self.spatial_grid) < 1:
                raise ValueError(
                    f"spatial_grid must be >= 1 per axis, got {self.spatial_grid}"
                )
            if self.spatial_grid == (1, 1):
                self.spatial_grid = None  # single device: plain path
        if data_devices == 0:
            data_devices = len(devices if devices is not None
                               else local_devices(deployed.device))
        self.data_devices = data_devices
        n_modes = sum(
            [spatial_devices > 1, data_devices > 1, self.spatial_grid is not None]
        )
        if n_modes > 1:
            raise ValueError(
                "spatial_devices, spatial_grid, and data_devices are mutually "
                "exclusive: shard one huge image (1-D rows or 2-D grid) OR "
                "batch-shard many tiles/frames"
            )

        def pool(n):
            return devices if devices is not None else local_devices(deployed.device, n)

        self._spatial_mesh = self._spatial_mesh_2d = self._data_devices = None
        self._replicas = None
        self._apply = deployed
        if self.spatial_grid is not None:
            ny, nx = self.spatial_grid
            self._spatial_mesh_2d = make_spatial_mesh(ny, nx, pool(ny * nx))
            flat = [d for row in self._spatial_mesh_2d for d in row]
            self._replicas = replicate(deployed, flat)
        elif spatial_devices > 1:
            self._spatial_mesh = make_mesh(spatial_devices, pool(spatial_devices))
            self._replicas = replicate(deployed, self._spatial_mesh)
        elif data_devices > 1:
            self._data_devices = serving_devices(data_devices, deployed.device, devices)
            self._replicas = replicate(deployed, self._data_devices)
            self._apply = self._data_apply
            # equal per-device work requires batch % data_devices == 0
            self.batch_size = -(-batch_size // data_devices) * data_devices

    def _data_apply(self, u8_batch) -> list:
        """Split the batch over the data devices and launch every replica
        on its shard; returns the output shards, in order, each on its
        device."""
        x = torch.as_tensor(np.ascontiguousarray(u8_batch)
                            if isinstance(u8_batch, np.ndarray) else u8_batch)
        shards = split_batch(x, self._data_devices)
        return [r(s) for r, s in zip(self._replicas, shards)]

    # -- whole frames (video path) -------------------------------------------
    def upscale_batch_device(self, batch_u8, n_valid=None):
        """Dispatch only: uint8 NHWC in -> (result, n frames). The
        result is a uint8 NHWC tensor on the device or, under
        ``data_devices``, its shards on their devices (``tiling.fetch``
        gathers either). It returns without waiting for the devices: on the
        card the input goes up from pinned memory without blocking, so the
        caller can fetch and encode the previous batch while this one
        computes (``cli/rs.py``'s video path). That copy up is the span
        ``model/upload``. ``n_valid``: how many leading frames are real
        (a video's last batch is padded with its last frame); a sequence
        model runs on those alone, since padding frames would reach the
        valid ones through its backward branch, and the other models
        take the whole batch (their frames are independent)."""
        x = torch.as_tensor(np.ascontiguousarray(batch_u8)
                            if isinstance(batch_u8, np.ndarray) else batch_u8)
        if self._sequence and n_valid is not None:
            x = x[:n_valid]
        n = x.shape[0]
        if self._data_devices is not None:
            pad = -n % self.data_devices
            if pad:  # fixed per-device shapes: repeat the last frame, crop after
                x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
            return self._data_apply(x), n
        if self.deployed.device.type == "cuda" and x.device.type == "cpu":
            with annotate("model/upload"):
                x = x.pin_memory().to(self.deployed.device, non_blocking=True)
        return self.deployed(x), n

    def upscale_batch(self, batch_u8: np.ndarray) -> np.ndarray:
        """uint8 NHWC RGB -> uint8 NHWC RGB at the model scale."""
        out, n = self.upscale_batch_device(batch_u8)
        return fetch(out)[:n]

    # -- arbitrary-size single images ----------------------------------------
    def upscale_image(self, image_u8: np.ndarray) -> np.ndarray:
        """uint8 HWC RGB of any size -> uint8 HWC RGB."""
        if self._sequence:
            raise ValueError(
                f"a {self.deployed.spec.family} artifact is a sequence model: it "
                f"upscales segments of video frames, not single images"
            )
        if self._spatial_mesh_2d is not None:
            return self._upscale_spatial_2d(image_u8)
        if self._spatial_mesh is not None:
            return self._upscale_spatial(image_u8)
        if self.window == 0:  # whole-image mode
            try:
                return self.deployed(image_u8[None]).cpu().numpy()[0]
            except torch.cuda.OutOfMemoryError:
                warnings.warn(
                    f"whole-image inference exhausted device memory for "
                    f"{image_u8.shape}; falling back to overlap tiling "
                    f"(latched for this engine)"
                )
                # latch: don't re-attempt the doomed allocation per image in
                # batch runs over equally huge inputs (window kept on the
                # downshuffle grid and above 2*overlap)
                w = max(96, 2 * self.overlap + 2)
                self.window = -(-w // self._grid) * self._grid
        return upscale_tiled(
            self._apply, image_u8,
            window=self.window or 96, overlap=self.overlap,
            batch_size=self.batch_size, grid=self._grid,
        )

    def _upscale_spatial(self, image_u8: np.ndarray) -> np.ndarray:
        """Row-band sharding with halo exchange over the spatial devices."""
        from ..parallel.spatial import spatial_apply

        n_tile = self.spatial_devices
        halo = max(self.overlap, 8)
        h, w = image_u8.shape[:2]
        # Pad rows so H divides the devices (band > halo for reflect halos).
        band = max(-(-h // n_tile), halo + 1)
        ph = band * n_tile
        _check_reflect_fit((h,), (ph - h,), f"spatial_devices={n_tile}", halo)
        padded = np.pad(image_u8, ((0, ph - h), (0, 0), (0, 0)), mode="reflect")
        s = self.deployed.spec.output_scale
        out = spatial_apply(self._replicas, torch.from_numpy(padded[None]),
                            self._spatial_mesh, halo=halo, scale=s)
        return out[0].numpy()[: h * s, : w * s]

    def _upscale_spatial_2d(self, image_u8: np.ndarray) -> np.ndarray:
        """2-D grid sharding with halo exchange in both dimensions."""
        from ..parallel.spatial import spatial_apply_2d

        ny, nx = self.spatial_grid
        halo = max(self.overlap, 8)
        h, w = image_u8.shape[:2]
        band_h = max(-(-h // ny), halo + 1)
        band_w = max(-(-w // nx), halo + 1)
        _check_reflect_fit(
            (h, w), (band_h * ny - h, band_w * nx - w),
            f"spatial_grid=({ny}, {nx})", halo,
        )
        padded = np.pad(
            image_u8,
            ((0, band_h * ny - h), (0, band_w * nx - w), (0, 0)),
            mode="reflect",
        )
        s = self.deployed.spec.output_scale
        out = spatial_apply_2d(self._replicas, torch.from_numpy(padded[None]),
                               self._spatial_mesh_2d, halo=halo, scale=s)
        return out[0].numpy()[: h * s, : w * s]
