"""Device lists for serving on several devices (counterpart of the JAX
package's ``core/mesh.py``).

JAX serves from one process over a ``Mesh`` of its local devices and lets
``shard_map`` place each shard. The port serves from one process over a
list of ``torch.device``s: each shard is a tensor on its own device, run
by a replica of the model built for that device. The lists here stand for
the meshes:

- ``make_mesh(n, devices)``: the first ``n`` devices (the JAX mesh's
  ``tile`` or ``data`` axis);
- ``make_spatial_mesh(ny, nx, devices)``: an (ny, nx) grid of them;
- ``serving_devices(n, device)``: the data axis over the local devices,
  0 meaning all of them;
- ``split_batch``/``gather``: ``batch_sharding``'s placement of dim 0 and
  the fetch of a result that lives on several devices.

On CUDA the local devices are the distinct cards, and asking for more
raises. On the CPU the one CPU stands for as many shards as asked (the
counterpart of the JAX tests' virtual host devices), so every sharded path
runs its whole logic there. Only a caller that passes ``devices=`` itself
repeats a card (tests, and ``chip_smoke.py`` on a one-card machine).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .device import resolve_device


def canonical(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card), so that
    two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device="cuda", n: Optional[int] = None) -> List[torch.device]:
    """The devices a serving path may shard over: on CUDA every local card
    (``cuda:0`` .. ``cuda:k-1``), whatever ``n``; on the CPU ``n`` entries
    of the one CPU (one when ``n`` is None or 0)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev] * max(n or 1, 1)


def make_mesh(n: int, devices: Sequence[torch.device]) -> List[torch.device]:
    """The first ``n`` of ``devices``: one axis of a JAX mesh."""
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} available")
    return list(devices[:n])


def make_spatial_mesh(n_y: int, n_x: int,
                      devices: Sequence[torch.device]) -> List[List[torch.device]]:
    """An (n_y, n_x) grid of the first n_y * n_x devices, row-major."""
    if n_y < 1 or n_x < 1:
        raise ValueError(f"spatial grid must be >= 1 per axis, got ({n_y}, {n_x})")
    flat = make_mesh(n_y * n_x, devices)
    return [flat[i * n_x:(i + 1) * n_x] for i in range(n_y)]


def serving_devices(n_devices: int, device="cuda",
                    devices: Optional[Sequence[torch.device]] = None
                    ) -> List[torch.device]:
    """The data axis for serving (0 = all local devices): the first
    ``n_devices`` of ``devices``, or of ``local_devices(device)``."""
    if n_devices < 0:
        raise ValueError(f"data_devices must be >= 0, got {n_devices}")
    local = list(devices) if devices is not None else local_devices(device, n_devices)
    n = n_devices or len(local)
    if n > len(local):
        raise ValueError(
            f"data_devices={n} but only {len(local)} local devices available")
    return local[:n]


def put(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` without blocking the host: a host tensor goes up
    from pinned memory, a tensor on another card is a peer copy ordered
    after its producer, one already there is returned as it is."""
    device = canonical(device)
    if x.device == device:
        return x
    if x.device.type == "cpu" and device.type == "cuda":
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def split_batch(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Dim 0 of ``x`` in ``len(devices)`` equal shards, shard i on
    ``devices[i]`` (``batch_sharding``)."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n} devices")
    return [put(s, d) for s, d in zip(x.chunk(n), devices)]


def gather(shards: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The shards concatenated along ``dim`` on ``device``. Call it after
    every shard was launched: each copy then waits for its own device
    only, while the others keep computing."""
    device = torch.device(device)
    return torch.cat([s.to(device) for s in shards], dim=dim)


def replicate(model, devices: Sequence[torch.device]) -> list:
    """One replica of ``model`` (a ``DeployedModel`` or an int8 server)
    per entry of ``devices``, built once per distinct device: ``model``
    itself on its own device, ``model.replica(d)`` on another."""
    built = {canonical(model.device): model}
    out = []
    for d in devices:
        key = canonical(d)
        if key not in built:
            built[key] = model.replica(key)
        out.append(built[key])
    return out
