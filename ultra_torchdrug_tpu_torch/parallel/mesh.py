"""The device mesh of the edge-partitioned paths (counterpart of
ultra_torchdrug_tpu/parallel/mesh.py).

A mesh has two axes, as in the JAX package: ``data`` (batch sharding) and
``edge`` (the entity graph's node rows split into ``edge`` blocks, one per
shard, each shard aggregating the edges of its block: the ring,
parallel/ring_rspmm.py, and the partitioned paths,
parallel/sharded_rspmm.py). A module-level context makes the active mesh
visible to the model code, as ``current_mesh`` does in the JAX package.

The ``data`` axis runs over processes (parallel/distributed.py): a
``data`` of N needs a process group of N processes, one a data row, and
the mesh of each process holds its own row. Each edge shard of that row
has a device of its own (``Mesh.devices``), placed as ``jax.make_mesh``
takes ``devices[:n]``: shard s of data row r on card ``(r * edge + s) mod
cuda_count`` (``shard_cards``). One card holds every shard; four cards and
``edge: 4`` hold one shard each; data 2 x edge 2 on four cards puts rank
0's shards on cards 0 and 1 and rank 1's on 2 and 3; with fewer cards than
shards the shards share cards in turn. Under a process group a rank's
row is its local rank (``distributed.rank_row``), and its home card, its
NCCL device, is that row's first card (``distributed.backend_rule``).
Shard 0's card is the row's home (``Mesh.device``): the model's
parameters, the loss and the optimizer live there. The partitioned path
and the ``xla`` body copy their operands to the shards' cards and their
results home inside their autograd nodes; the ring's entity tower keeps
its node states on the shards' cards from the boundary to the readout
(parallel/card_rows.py). A device with an index
(``cuda:0``, or ``cpu``) pins every shard to it, and ``devices`` may name
each shard's device. ``make_mesh`` logs where every shard went.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Optional, Sequence

import torch

from ..utils.logging import LOGGER_NAME
from .placement import indexed

AXIS_NAMES = ("data", "edge")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes, this process's data row (``data_index``) and the device
    of each of that row's edge shards (shard s at ``devices[s]``)."""

    data: int
    edge: int
    devices: tuple
    data_index: int = 0

    axis_names = AXIS_NAMES

    @property
    def shape(self) -> dict:
        return {"data": self.data, "edge": self.edge}

    @property
    def device(self) -> torch.device:
        """The row's home: shard 0's device, where the parameters, the loss
        and the optimizer live (and the node states between convs, but for
        the ring's entity tower, which keeps them on the shards' cards)."""
        return self.devices[0]


_CURRENT_MESH: Optional[Mesh] = None


def launch_command(data: int) -> str:
    return (f"torchrun --nproc_per_node {data} -m "
            "ultra_torchdrug_tpu_torch.run_full -c <config with parallel: "
            f"{{data: {data}}}>")


def shard_cards(row: int, edge: int, count: int) -> list:
    """The placement rule: the card index of each edge shard of data row
    ``row`` on a host of ``count`` cards, shard s on ``(row * edge + s) mod
    count`` (``jax.make_mesh``'s ``devices[:n]``, wrapped)."""
    if count < 1:
        raise ValueError(f"no card to place {edge} shards on")
    return [(row * edge + s) % count for s in range(edge)]


def make_mesh(data: int = 1, edge: int = 1, device=None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``data`` x ``edge`` mesh: this process's data row and its ``edge``
    shards' devices. ``device`` is "cuda" unless the caller names another:
    "cuda" places the shards on the host's cards by ``shard_cards``
    (under a process group from the rank's home card on), a device with
    an index or the CPU takes every shard. ``devices``, one per shard of
    the row, may be given instead; they must share one device type. A
    ``data`` > 1 needs a process group of exactly ``data`` processes."""
    from .. import default_device
    from . import distributed

    data, edge = int(data), int(edge)
    if data < 1 or edge < 1:
        raise ValueError(f"mesh {data}x{edge}: axis sizes must be >= 1")
    world = distributed.process_count()
    if data != world and (data > 1 or world > 1):
        raise ValueError(
            f"a data axis of {data} needs {data} processes, one a data row, "
            f"but the process group has {world}: launch "
            f"`{launch_command(data)}`")
    if devices is None:
        devices = _placed(edge, device, world, default_device, distributed)
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != edge:
        raise ValueError(f"mesh {data}x{edge} needs {edge} devices a data "
                         f"row, got {len(devices)}")
    kinds = sorted({d.type for d in devices})
    if len(kinds) > 1:
        raise ValueError(f"a mesh's shards share one device type, got "
                         f"{kinds} in {[str(d) for d in devices]}")
    devices = tuple(indexed(d) for d in devices)
    mesh = Mesh(data=data, edge=edge, devices=devices,
                data_index=distributed.process_index())
    logging.getLogger(LOGGER_NAME).info(
        "mesh data=%d x edge=%d: data row %d, home %s, shards on %s", data,
        edge, mesh.data_index, devices[0], [str(d) for d in devices])
    return mesh


def _placed(edge: int, device, world: int, default_device,
            distributed) -> tuple:
    """The row's shard devices when the caller names none (``make_mesh``)."""
    if world > 1:
        row = distributed.rank_row()
        if row is None:  # the ranks were pinned to a device
            return (distributed.rank_device(device),) * edge
    else:
        row, device = 0, default_device(device)
        if device.type != "cuda" or device.index is not None:
            return (device,) * edge
    cards = shard_cards(row, edge, torch.cuda.device_count())
    if world > 1 and cards[0] != distributed.rank_device().index:
        raise ValueError(
            f"rank {row}'s home is {distributed.rank_device()}, but a row of "
            f"{edge} shards starts on cuda:{cards[0]}: join the process "
            f"group with initialize_distributed(edge={edge})")
    return tuple(torch.device("cuda", c) for c in cards)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the active mesh for the scope (None: no mesh)."""
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev
