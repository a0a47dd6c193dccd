"""Spatially sharded inference with halo exchange (counterpart of the JAX
package's ``parallel/spatial.py``).

One image is cut into row bands (``spatial_apply``) or a grid of blocks
(``spatial_apply_2d``), one per device. Each block borrows ``halo`` rows
(and columns) from its neighbours, runs the network on the extended block
on its own device, and crops the halo from its output. At the image's
edges the halo is numpy's ``'reflect'`` padding (edge row excluded), so
with halo >= the network's receptive-field radius the result equals one
run on the reflect-padded whole image.

JAX's ``ppermute`` becomes a copy of the halo slab to the neighbour's
device (``core.mesh.put``: a peer copy between cards, nothing on one
device). ``net_apply`` holds one callable per device, each running on its
device (the engine passes a ``DeployedModel`` replica per device, so an
``sr`` band runs K1). Every block is launched before any output is
fetched, so distinct cards compute concurrently.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..core.mesh import gather, put

NetApply = Sequence[Callable[[torch.Tensor], torch.Tensor]]


def _halo_exchange(blocks: List[torch.Tensor], halo: int, dim: int) -> List[torch.Tensor]:
    """Each block extended by ``halo`` on both sides of ``dim``: the
    neighbours' edge slabs, copied to the block's device, and reflect
    padding at the ends of the row of blocks."""
    n = len(blocks)
    out = []
    for i, x in enumerate(blocks):
        size = x.shape[dim]
        if i > 0:
            before = put(blocks[i - 1].narrow(dim, blocks[i - 1].shape[dim] - halo, halo),
                         x.device)
        else:
            before = x.narrow(dim, 1, halo).flip(dim)
        if i < n - 1:
            after = put(blocks[i + 1].narrow(dim, 0, halo), x.device)
        else:
            after = x.narrow(dim, size - halo - 1, halo).flip(dim)
        out.append(torch.cat([before, x, after], dim=dim))
    return out


def spatial_apply(net_apply: NetApply, image: torch.Tensor,
                  devices: Sequence[torch.device], halo: int = 32,
                  scale: int = 2) -> torch.Tensor:
    """``net_apply[i]`` on row band i of an NHWC image, band i on
    ``devices[i]``. image: (N, H, W, C) with H divisible by the device
    count. Returns (N, H*scale, W*scale, C') on the host."""
    n = len(devices)
    if image.shape[1] % n:
        raise ValueError(f"H={image.shape[1]} not divisible by tile axis {n}")
    band = image.shape[1] // n
    if halo >= band:
        raise ValueError(f"halo {halo} must be < band height {band}")
    bands = [put(b, d) for b, d in zip(image.split(band, dim=1), devices)]
    extended = _halo_exchange(bands, halo, dim=1)
    outs = [f(x) for f, x in zip(net_apply, extended)]  # all launched
    crop = slice(halo * scale, (halo + band) * scale)
    return gather([o[:, crop] for o in outs], "cpu", dim=1)


def spatial_apply_2d(net_apply: NetApply, image: torch.Tensor,
                     grid: Sequence[Sequence[torch.device]], halo: int = 32,
                     scale: int = 2) -> torch.Tensor:
    """2-D spatial parallelism over an (ny, nx) device ``grid``
    (``core.mesh.make_spatial_mesh``); ``net_apply`` holds one callable
    per grid entry, row-major. The column exchange runs on the
    row-extended blocks, so the slabs a block receives from its x
    neighbours carry those neighbours' own row halos: the corners.

    image: (N, H, W, C), H % ny == 0 and W % nx == 0. Returns the result
    on the host."""
    n_y, n_x = len(grid), len(grid[0])
    if image.shape[1] % n_y or image.shape[2] % n_x:
        raise ValueError(
            f"H={image.shape[1]}, W={image.shape[2]} not divisible by "
            f"tile grid ({n_y}, {n_x})"
        )
    band_h = image.shape[1] // n_y
    band_w = image.shape[2] // n_x
    if halo >= band_h or halo >= band_w:
        raise ValueError(f"halo {halo} must be < band ({band_h}, {band_w})")
    blocks = [[put(b, d) for b, d in zip(row.split(band_w, dim=2), grid[i])]
              for i, row in enumerate(image.split(band_h, dim=1))]
    columns = [_halo_exchange([blocks[i][j] for i in range(n_y)], halo, dim=1)
               for j in range(n_x)]
    rows = [_halo_exchange([columns[j][i] for j in range(n_x)], halo, dim=2)
            for i in range(n_y)]
    outs = [[net_apply[i * n_x + j](x) for j, x in enumerate(row)]  # all launched
            for i, row in enumerate(rows)]
    ch = slice(halo * scale, (halo + band_h) * scale)
    cw = slice(halo * scale, (halo + band_w) * scale)
    return gather([gather([o[:, ch, cw] for o in row], "cpu", dim=2)
                   for row in outs], "cpu", dim=1)
