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

Training over several devices runs one process per card, started by
``torch.distributed.run`` (torchrun), where JAX runs one process per host
over a mesh of its devices. ``distributed_init`` reads torchrun's
environment and joins the process group; ``local_mesh`` is this process's
place in it (a JAX host is a node, a JAX local device a rank on that
node); ``shrink_data_group`` is the JAX CLI's data-mesh shrink; and
``all_reduce_``, ``gather_rows`` and ``broadcast_object`` are the
collectives training needs over the data group, each a no-op in one
process. ``torch.distributed`` is reached only inside the functions that
use a process group, so a one-process run calls nothing of it and runs
on a torch built without it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence

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


# ------------------------------------------------------ data-parallel training --

@dataclass(frozen=True)
class DataMesh:
    """This process's place in data-parallel training: ``rank`` of ``world``
    processes, ``local_rank`` of the ``local_world`` on its node, the card
    it trains on, and the data group that BatchNorm statistics, gradients
    and losses are reduced over (``size`` ranks; ``group`` None in one
    process, or on a rank the shrink left out)."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    device: Optional[torch.device] = None
    group: Any = None
    size: int = 1
    initialized: bool = False

    @property
    def node(self) -> int:
        """The JAX process index: ranks are numbered node by node."""
        return self.rank // self.local_world

    @property
    def nodes(self) -> int:
        """The JAX process count."""
        return self.world // self.local_world

    @property
    def ranks_per_node(self) -> int:
        """Ranks of the data group on each node (``local_world``, or fewer
        after the shrink)."""
        return self.size // self.nodes


_MESH = DataMesh()
_GROUPS: Dict[int, Any] = {}  # data groups by size: the world's, and shrunk ones


def local_mesh() -> DataMesh:
    """The data mesh of training as ``distributed_init`` and
    ``shrink_data_group`` left it (one process: rank 0 of 1, no group)."""
    return _MESH


def _launched() -> bool:
    """True under torchrun (which sets this even for one process)."""
    return "TORCHELASTIC_RUN_ID" in os.environ


def distributed_init(device="cuda", backend: Optional[str] = None, *,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     devices: Optional[Sequence[torch.device]] = None) -> DataMesh:
    """Join the process group of data-parallel training; returns
    ``local_mesh()``. Arguments left None come from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
    ``MASTER_ADDR``/``MASTER_PORT`` through ``init_method="env://"``).

    Without ``WORLD_SIZE``, or with ``WORLD_SIZE=1`` outside torchrun, it
    does nothing: one process. Otherwise it joins with NCCL on ``cuda`` and
    gloo on ``cpu`` (or ``backend``), on ``cuda:LOCAL_RANK``, and raises
    when the node runs more ranks than it has cards: two ranks never share
    a card unless ``devices`` (one entry per local rank) says so. Calling it
    again returns the group already joined."""
    global _MESH
    if _MESH.initialized:
        return _MESH
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return _MESH
        world_size = int(os.environ["WORLD_SIZE"])
        if world_size == 1 and not _launched():
            return _MESH
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    local_world = (int(env.get("LOCAL_WORLD_SIZE", world_size)) if local_world_size is None
                   else local_world_size)
    if world_size % local_world or not 0 <= local_rank < local_world:
        raise ValueError(f"rank {rank}: local rank {local_rank} of {local_world} per node "
                         f"does not fit a world of {world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if devices is not None:
            dev = canonical(devices[local_rank])
        else:
            cards = torch.cuda.device_count()
            if local_world > cards:
                raise RuntimeError(
                    f"distributed_init: {local_world} processes on this node but "
                    f"torch.cuda.device_count() = {cards}: data-parallel training runs "
                    f"one process per card (--nproc_per_node {cards} at most)")
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    import torch.distributed as dist

    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    _GROUPS[world_size] = dist.group.WORLD
    _MESH = DataMesh(rank, world_size, local_rank, local_world, dev, dist.group.WORLD,
                     world_size, True)
    return _MESH


def distributed_teardown() -> None:
    """Leave the process group (a no-op in one process)."""
    global _MESH
    if _MESH.initialized:
        import torch.distributed as dist

        dist.destroy_process_group()
    _MESH = DataMesh()
    _GROUPS.clear()


def largest_divisible_device_count(batch_size: int, n_devices: int) -> int:
    """Largest device count <= n_devices that divides batch_size: the JAX
    CLI's data-mesh shrink (keep the user's batch, drop devices only as
    needed)."""
    return max(d for d in range(1, max(n_devices, 1) + 1) if batch_size % d == 0)


def shrink_data_group(batch_size: int) -> int:
    """The JAX CLI's data mesh for a per-node ``batch_size``: on several
    nodes every rank, and the batch must divide by the ranks per node
    (raises SystemExit with JAX's message); on one node the first
    ``largest_divisible_device_count(batch_size, local_world)`` ranks,
    which become the data group (every rank takes part in making it; the
    others are left with no group). Returns that count."""
    global _MESH
    mesh = _MESH
    if not mesh.initialized:
        return 1
    if mesh.nodes > 1:
        if batch_size % mesh.local_world:
            raise SystemExit(f"multi-host: per-host --batch_size {batch_size} must be "
                             f"divisible by the local device count {mesh.local_world}")
        return mesh.world
    k = largest_divisible_device_count(batch_size, mesh.world)
    if k not in _GROUPS:
        import torch.distributed as dist

        _GROUPS[k] = dist.new_group(list(range(k)))
    _MESH = replace(mesh, group=_GROUPS[k] if mesh.rank < k else None, size=k)
    return k


def data_group():
    """The process group data-parallel training reduces over; None in one
    process."""
    return _MESH.group


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group, in place (no-op in one process)."""
    if _MESH.group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, group=_MESH.group)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order, (size, *t.shape), on every
    rank: a zero table holding this rank's ``t`` in its row, summed over
    the group. Adding zeros is exact, so each row is that rank's ``t`` bit
    for bit, and it takes only an all-reduce, which gloo also runs on CUDA
    tensors. (The data group is the first ``size`` ranks, so a rank's row
    is its rank.)"""
    if _MESH.group is None:
        return t[None]
    table = torch.zeros((_MESH.size, *t.shape), dtype=t.dtype, device=t.device)
    table[_MESH.rank] = t
    return all_reduce_(table)


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable; tensors on the host) on every rank of
    the data group (``obj`` itself in one process)."""
    if _MESH.group is None:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_MESH.group)
    return box[0]
