"""Overlap-tiled full-image inference (counterpart of the JAX package's
``infer/tiling.py``).

Tiles lie on a fixed grid with configurable overlap; every tile has the
same shape (edge coverage comes from reflect-padding the image), tiles run
in fixed-size batches, and each output tile contributes only its central
stride region. With overlap >= the network's receptive-field radius the
tiled result equals whole-image inference; ``overlap=0`` is the reference's
non-overlap tiling. The scale is read from the first output batch.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.mesh import gather
from ..utils.profiling import annotate

Result = Union[torch.Tensor, Sequence[torch.Tensor]]


def fetch(out: Result) -> np.ndarray:
    """A result as one host array: a tensor on its device, or the shards
    of a batch split over several devices, concatenated in order."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return gather(out, "cpu").numpy()


def plan_tiles(
    height: int, width: int, window: int, overlap: int
) -> Tuple[List[Tuple[int, int]], int, int, int]:
    """Grid positions (top-left in PADDED coords) + stride + padded dims."""
    if overlap < 0 or overlap * 2 >= window:
        raise ValueError(f"need 0 <= overlap < window/2, got {overlap}/{window}")
    stride = window - 2 * overlap
    ny = max(1, math.ceil(height / stride))
    nx = max(1, math.ceil(width / stride))
    padded_h = ny * stride + 2 * overlap
    padded_w = nx * stride + 2 * overlap
    positions = [(iy * stride, ix * stride) for iy in range(ny) for ix in range(nx)]
    return positions, stride, padded_h, padded_w


def upscale_tiled(
    apply_fn: Callable[[np.ndarray], Result],
    image: np.ndarray,
    window: int = 96,
    overlap: int = 8,
    batch_size: int = 8,
    grid: int = 1,
) -> np.ndarray:
    """Tile -> batch -> model -> stitch. image: HWC uint8; returns HWC uint8.

    ``apply_fn`` maps a uint8 NHWC batch of ``window``-sized tiles to uint8
    NHWC outputs (a ``DeployedModel``), or to their shards on several
    devices: the engine's data-sharded apply splits each batch across
    devices, the counterpart of the JAX function's ``sharding=``, and the
    output equals the unsharded path's. Batches are padded to a fixed size
    by repeating the last tile, and each batch comes back to the host in
    one copy per device. ``grid`` > 1 keeps the shrunk small-image window
    on the model's downshuffle grid.

    The stages are the spans ``tile/cut`` (pad, stack, batch padding),
    ``tile/fetch`` (each batch's wait for its forward and copy down) and
    ``tile/stitch`` (``utils.profiling.annotate``). The function's integer
    attributes count over every call: ``tiles`` cut, ``tiles_run``
    (with the repeats that pad batches), and output pixels ``out_px_run``
    (computed by the model) and ``out_px_kept`` (written into results).
    """
    h, w = image.shape[:2]
    window = min(window, max(h, w) + 2 * overlap)
    if grid > 1:
        window = -(-window // grid) * grid
    positions, stride, ph, pw = plan_tiles(h, w, window, overlap)

    with annotate("tile/cut"):
        pad_bottom = ph - overlap - h
        pad_right = pw - overlap - w
        padded = np.pad(
            image,
            ((overlap, max(pad_bottom, 0)), (overlap, max(pad_right, 0)), (0, 0)),
            mode="reflect",
        )
        tiles = np.stack([padded[y:y + window, x:x + window] for (y, x) in positions])
        n_tiles = len(tiles)
        n_chunks = -(-n_tiles // batch_size)
        pad_n = n_chunks * batch_size - n_tiles
        if pad_n:
            tiles = np.concatenate([tiles, np.repeat(tiles[-1:], pad_n, axis=0)])
    outs = []
    for i in range(n_chunks):
        out = apply_fn(tiles[i * batch_size:(i + 1) * batch_size])
        with annotate("tile/fetch"):
            outs.append(fetch(out))
    with annotate("tile/stitch"):
        out_tiles = np.concatenate(outs)[:n_tiles]
        if out_tiles.shape[1] % window:
            raise ValueError(f"non-integer scale: {out_tiles.shape[1]}/{window}")
        s = out_tiles.shape[1] // window
        canvas = np.zeros((h * s, w * s, image.shape[2]), out_tiles.dtype)
        ov = overlap * s
        st = stride * s
        for (y, x), tile in zip(positions, out_tiles):
            core = tile[ov:ov + st, ov:ov + st]
            oy, ox = y * s, x * s
            cy = min(st, h * s - oy)
            cx = min(st, w * s - ox)
            if cy <= 0 or cx <= 0:
                continue
            canvas[oy:oy + cy, ox:ox + cx] = core[:cy, :cx]
    upscale_tiled.tiles += n_tiles
    upscale_tiled.tiles_run += len(tiles)
    upscale_tiled.out_px_run += len(tiles) * (window * s) ** 2
    upscale_tiled.out_px_kept += h * s * w * s
    return canvas


upscale_tiled.tiles = 0
upscale_tiled.tiles_run = 0
upscale_tiled.out_px_run = 0
upscale_tiled.out_px_kept = 0
