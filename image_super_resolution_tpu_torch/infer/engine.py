"""Batched tiled inference engine over a deployed model, on one device
(counterpart of the JAX package's ``infer/engine.py``)."""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..models.deploy import DeployedModel
from .tiling import upscale_tiled


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
    ):
        """window=0 selects whole-image (untiled) inference. Sharding over
        several devices (``spatial_devices``, ``spatial_grid``,
        ``data_devices``) comes with the multi-GPU slice (slice 5)."""
        if spatial_devices != 1 or data_devices != 1 or (
            spatial_grid and tuple(spatial_grid) != (1, 1)
        ):
            raise NotImplementedError(
                "multi-device serving (spatial_devices, spatial_grid, "
                "data_devices) comes with slice 5 (multi-GPU)"
            )
        self.deployed = deployed
        self.window = window
        self.overlap = overlap
        self.batch_size = batch_size
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
        # must start on the model's space_to_depth grid.
        self._grid = getattr(getattr(deployed, "spec", None),
                             "downshuffle", 1) or 1
        if self._grid > 1:
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

    def upscale_batch_device(self, batch_u8: np.ndarray):
        """Dispatch only: uint8 NHWC in -> (uint8 NHWC tensor on the device,
        n input frames). It returns without waiting for the device: on the
        card the input goes up from pinned memory without blocking, so the
        caller can fetch and encode the previous batch while this one
        computes (``cli/rs.py``'s video path)."""
        x = torch.as_tensor(np.ascontiguousarray(batch_u8)
                            if isinstance(batch_u8, np.ndarray) else batch_u8)
        if self.deployed.device.type == "cuda" and x.device.type == "cpu":
            x = x.pin_memory().to(self.deployed.device, non_blocking=True)
        return self.deployed(x), x.shape[0]

    def upscale_batch(self, batch_u8: np.ndarray) -> np.ndarray:
        """uint8 NHWC RGB -> uint8 NHWC RGB at the model scale."""
        return self.upscale_batch_device(batch_u8)[0].cpu().numpy()

    def upscale_image(self, image_u8: np.ndarray) -> np.ndarray:
        """uint8 HWC RGB of any size -> uint8 HWC RGB."""
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
            self.deployed, image_u8,
            window=self.window or 96, overlap=self.overlap,
            batch_size=self.batch_size, grid=self._grid,
        )
