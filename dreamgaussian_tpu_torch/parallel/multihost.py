"""Process groups and the (data, tile) mesh over ``torch.distributed``.

Port of ``dreamgaussian_tpu/parallel/multihost.py``. Every rank is one
process: it calls :func:`initialize_multihost` (``env://`` under
``torchrun``, or an explicit address, world size and rank) and then
:func:`make_mesh_2d`, which every rank builds alike. The trainers keep all
random state (the numpy camera RNG, the trainer's ``draw``) seeded alike on
every rank and reduce the gradients and densify statistics before they use
them, so the parameters stay equal on every rank without any parameter
traffic.

Backend, by rule:

- ``nccl`` when every rank runs on a card of its own (CUDA, and no more
  ranks on the host than cards);
- ``gloo`` when ranks share a card (NCCL refuses two ranks on one device;
  gloo reduces CUDA tensors through the host) or run on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .. import resolve_device


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def choose_backend(device: str | torch.device, local_world_size: int) -> str:
    """``nccl`` when each of the host's ``local_world_size`` ranks has a card
    of its own, else ``gloo`` (ranks on one card, or on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % cards}`` for ``cuda`` (every
    rank of a one-card host shares ``cuda:0``), else ``device`` as given.
    Raises for a missing card (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())


def use_rank_device(device: str | torch.device = "cuda") -> torch.device:
    """:func:`rank_device`, made the current CUDA device of this process
    (the device NCCL's communicator and a kernel's launch take when none is
    named)."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def initialize_multihost(init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None,
                         device: str | torch.device = "cuda") -> str | None:
    """Join this process to the default process group; a no-op (returns
    None) for one process. Without arguments it reads ``torchrun``'s
    environment (``env://``: WORLD_SIZE, RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT); else give ``init_method`` (for example
    ``tcp://localhost:<port>``), ``world_size`` and ``rank``. The rank's
    card (:func:`rank_device`) becomes the current device first; the
    backend is :func:`choose_backend`'s for ``device`` and the host's ranks
    (LOCAL_WORLD_SIZE, else the world size). Returns the backend."""
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    if world_size <= 1:
        return None
    rank = _env_int("RANK", 0) if rank is None else rank
    use_rank_device(device)
    backend = choose_backend(device, _env_int("LOCAL_WORLD_SIZE", world_size))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return backend


@dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its size, this rank's
    coordinate on it, and the process group of the ranks that share this
    rank's other coordinate (None when the axis has one rank)."""

    size: int
    index: int
    group: Any = None


@dataclass(frozen=True)
class Mesh2D:
    """A (data, tile) mesh of ranks: rank = data_index * tile + tile_index,
    so a tile group is a run of consecutive ranks (one host under
    ``torchrun``) and the data axis runs across hosts, as the JAX mesh lays
    its data axis across hosts and its tile axis within one."""

    data: Axis
    tile: Axis
    rank: int
    device: torch.device
    backend: str | None

    def describe(self) -> str:
        return f"data={self.data.size}xtile={self.tile.size}"


def make_mesh_2d(data: int | None = None, tile: int = 1,
                 device: str | torch.device = "cuda") -> Mesh2D:
    """The global (data, tile) mesh over every rank of the default process
    group (one rank when none is initialised). Every rank calls it with the
    same arguments: each subgroup is created on every rank, in one order.
    The rank's device (:func:`rank_device`) becomes the current device, so
    the kernels and the collectives of a rank on ``cuda:N`` run there."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        if n % tile:
            raise ValueError(f"tile={tile} does not divide {n} ranks")
        data = n // tile
    if data * tile != n:
        raise ValueError(f"a data={data}xtile={tile} mesh needs {data * tile} ranks, "
                         f"the process group has {n}")
    d_idx, t_idx = divmod(rank, tile)
    data_group = tile_group = None
    if n > 1:
        for t in range(tile):          # one data group per tile coordinate
            ranks = [d * tile + t for d in range(data)]
            g = dist.new_group(ranks) if data > 1 else None
            if t == t_idx:
                data_group = g
        for d in range(data):          # one tile group per data coordinate
            ranks = [d * tile + t for t in range(tile)]
            g = dist.new_group(ranks) if tile > 1 else None
            if d == d_idx:
                tile_group = g
    backend = dist.get_backend() if dist.is_initialized() else None
    return Mesh2D(data=Axis(data, d_idx, data_group), tile=Axis(tile, t_idx, tile_group),
                  rank=rank, device=use_rank_device(device), backend=backend)


def rays_per_second(width: int, height: int, n_views: int,
                    seconds_per_step: float) -> float:
    """Rays (pixels) rendered per second: the scaling metric of the JAX
    package's baseline."""
    return width * height * n_views / seconds_per_step
