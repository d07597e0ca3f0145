"""Process groups and the (data, tile) mesh over ``torch.distributed``.

Port of ``dreamgaussian_tpu/parallel/multihost.py``. Every rank is one
process: it calls :func:`initialize_multihost` (``env://`` under
``torchrun``, or an explicit address, world size and rank) and then
:func:`make_mesh_2d`, which every rank builds alike. The trainers keep all
random state (the numpy camera RNG, the trainer's ``draw``) seeded alike on
every rank and reduce the gradients and densify statistics before they use
them, so the parameters stay equal on every rank without any parameter
traffic.

Ranks on several hosts (nodes) are started by one ``torchrun`` per node,
``--nnodes N --node-rank n`` at one rendezvous: each process reads RANK,
LOCAL_RANK, LOCAL_WORLD_SIZE and GROUP_RANK (its node) as torchrun sets
them and runs on its node's card ``cuda:{LOCAL_RANK % cards}``.

Backend, by one rule that every rank applies to the same list: before the
process group exists, each rank posts the card it runs on (the CUDA
device's UUID, or "cpu") to the rendezvous store and reads every other
rank's (:func:`agree_backend`). Then

- ``nccl`` when every rank runs on a card and no two ranks anywhere share
  one;
- ``gloo`` otherwise: ranks on the CPU, or two ranks on one card (NCCL
  refuses two ranks on one device; gloo reduces CUDA tensors through the
  host). Two launchers on one host that both run a rank on its ``cuda:0``
  see one UUID twice, and hosts with different card counts take the same
  backend, since nothing is decided from one host's view.
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


def card_identity(device: str | torch.device) -> str:
    """The card a rank runs on, comparable across hosts and launchers: the
    UUID of the CUDA device ``device`` (an index names a card only within
    one process's view), or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(dev).uuid)


def choose_backend(cards: list) -> str:
    """``nccl`` when every rank's card (``card_identity``, one per rank) is
    a CUDA device and no two ranks share one, else ``gloo``."""
    if "cpu" not in cards and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def agree_backend(store, rank: int, world_size: int, device: str | torch.device) -> str:
    """Post this rank's card to ``store`` and read every rank's: the backend
    of :func:`choose_backend` over all of them, the same on every rank."""
    cards = dist.PrefixStore("dreamgaussian/cards", store)
    cards.set(str(rank), card_identity(device))
    return choose_backend([cards.get(str(r)).decode() for r in range(world_size)])


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
    environment (``env://``: WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), on one node or several; else give ``init_method`` (for
    example ``tcp://localhost:<port>``), ``world_size`` and ``rank``. The
    rank's card (:func:`rank_device`) becomes the current device first;
    the ranks then meet at the rendezvous store, agree on the backend
    there (:func:`agree_backend`) and build the group on that store.
    Returns the backend."""
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    if world_size <= 1:
        return None
    rank = _env_int("RANK", 0) if rank is None else rank
    dev = use_rank_device(device)
    store, rank, world_size = next(dist.rendezvous(init_method or "env://", rank=rank,
                                                   world_size=world_size))
    backend = agree_backend(store, rank, world_size, dev)
    dist.init_process_group(backend, store=store, world_size=world_size, rank=rank)
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
