"""The device mesh of the edge-partitioned paths (counterpart of
ultra_torchdrug_tpu/parallel/mesh.py).

A mesh has two axes, as in the JAX package: ``data`` (batch sharding) and
``edge`` (the entity graph's node rows split into ``edge`` blocks, one per
shard, each shard aggregating the edges of its block and passing its node
states around a ring: parallel/ring_rspmm.py). A module-level context makes
the active mesh visible to the model code, as ``current_mesh`` does in the
JAX package.

The ``data`` axis runs over processes (parallel/distributed.py): a
``data`` of N needs a process group of N processes, one a data row, and
the mesh of each process holds its own row. That row's edge shards all
live on the process's one device (its rank's card, or the CPU when the
caller names it), as in the JAX package's virtual-device mesh (one host
driving many shards): the whole ring algorithm runs, each shard's block a
slice of one tensor on the device. So data across processes x edge within
each process is the JAX package's composed layout. Not ported yet, and
raising here (ROADMAP Queue 1 item 9, several cards): a row's shards on
more than one device (the ring shift's writes over NVLink).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Optional, Sequence

import torch

from ..utils.logging import LOGGER_NAME

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
        """The one device that every shard lives on in this port."""
        return self.devices[0]


_CURRENT_MESH: Optional[Mesh] = None


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: a row's shards on several cards are "
                               "not ported yet (ROADMAP Queue 1 item 9, "
                               "several cards); the port's mesh places every "
                               "edge shard on one device")


def launch_command(data: int) -> str:
    return (f"torchrun --nproc_per_node {data} -m "
            "ultra_torchdrug_tpu_torch.run_full -c <config with parallel: "
            f"{{data: {data}}}>")


def make_mesh(data: int = 1, edge: int = 1, device=None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``data`` x ``edge`` mesh: this process's data row, its ``edge``
    shards all on ``device`` (the card unless the caller names another;
    under a process group the rank's own, ``distributed.rank_device``).
    ``devices``, one per shard of the row, may be given instead; they must
    all be the same device. A ``data`` > 1 needs a process group of exactly
    ``data`` processes."""
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
        if world > 1:
            device = distributed.rank_device(device)
        devices = (default_device(device),) * edge
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != edge:
        raise ValueError(f"mesh {data}x{edge} needs {edge} devices a data "
                         f"row, got {len(devices)}")
    if len(set(devices)) > 1:
        names = sorted(map(str, set(devices)))
        raise _unported(f"edge shards on several devices {names}")
    mesh = Mesh(data=data, edge=edge, devices=devices,
                data_index=distributed.process_index())
    logging.getLogger(LOGGER_NAME).info(
        "mesh data=%d x edge=%d: data row %d, its shards on %s", data, edge,
        mesh.data_index, devices[0])
    return mesh


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
