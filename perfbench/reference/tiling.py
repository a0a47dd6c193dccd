"""Plain reference of overlap tiling: the tile grid, the reflect padding of
the image and the stitch of each output tile's central region.

A ``window``-sized tile starts every ``stride = window - 2 * overlap``
input pixels; the image is reflect-padded by ``overlap`` on the top and
left and by whatever the grid needs on the bottom and right; each output
tile gives the canvas its central ``stride * scale`` square, cropped at the
image's far edges. An image smaller than the window shrinks the window to
``max(h, w) + 2 * overlap``, rounded up to a multiple of ``grid`` (a model
that space-to-depths its input by ``grid`` needs tiles on that grid). The
scale is the outputs' size over the window's.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np


def plan(h: int, w: int, window: int, overlap: int, grid: int = 1
         ) -> Tuple[int, int, List[Tuple[int, int]], int, int]:
    """(window, stride, tile origins in padded coordinates, padded h, w)."""
    window = min(window, max(h, w) + 2 * overlap)
    window = -(-window // grid) * grid
    stride = window - 2 * overlap
    ny, nx = max(1, math.ceil(h / stride)), max(1, math.ceil(w / stride))
    origins = [(iy * stride, ix * stride) for iy in range(ny) for ix in range(nx)]
    return window, stride, origins, ny * stride + 2 * overlap, nx * stride + 2 * overlap


def upscale(apply: Callable[[np.ndarray], np.ndarray], image: np.ndarray, window: int,
            overlap: int, block: int = 8, grid: int = 1) -> np.ndarray:
    """``apply`` maps uint8 NHWC tiles to uint8 NHWC outputs, each a whole
    multiple of the tile's size; tiles go to it ``block`` at a time. Returns
    the stitched uint8 HWC."""
    h, w = image.shape[:2]
    window, stride, origins, ph, pw = plan(h, w, window, overlap, grid)
    padded = np.pad(image, ((overlap, ph - overlap - h), (overlap, pw - overlap - w), (0, 0)),
                    mode="reflect")
    canvas = None
    for i in range(0, len(origins), block):
        part = origins[i:i + block]
        outs = apply(np.stack([padded[y:y + window, x:x + window] for y, x in part]))
        if canvas is None:
            scale = outs.shape[1] // window
            canvas = np.zeros((h * scale, w * scale, image.shape[2]), np.uint8)
            ov, st = overlap * scale, stride * scale
        for (y, x), tile in zip(part, outs):
            oy, ox = y * scale, x * scale
            cy, cx = min(st, h * scale - oy), min(st, w * scale - ox)
            canvas[oy:oy + cy, ox:ox + cx] = tile[ov:ov + cy, ov:ov + cx]
    return canvas
