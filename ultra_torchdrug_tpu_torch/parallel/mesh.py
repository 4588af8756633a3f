"""The device mesh of the edge-partitioned paths (counterpart of
ultra_torchdrug_tpu/parallel/mesh.py).

A mesh has two axes, as in the JAX package: ``data`` (batch sharding) and
``edge`` (the entity graph's node rows split into ``edge`` blocks, one per
shard, each shard aggregating the edges of its block and passing its node
states around a ring: parallel/ring_rspmm.py). A module-level context makes
the active mesh visible to the model code, as ``current_mesh`` does in the
JAX package.

This port places every shard on the run's one device: the card unless the
caller names another, as the tests name the CPU. That is the JAX package's
own virtual-device mesh (one host driving many shards): the whole ring
algorithm runs, each shard's block a slice of one tensor on the device. Not
ported yet, and raising here (ROADMAP Queue 1 item 9): ``data`` > 1 (data
parallelism through ``torch.distributed``) and shards on more than one
device (the ring shift's writes over NVLink).
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
    """Axis sizes and the device of each shard (edge shard s of data row d
    at ``devices[d * edge + s]``)."""

    data: int
    edge: int
    devices: tuple

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
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               "item 9); the port's mesh places every edge "
                               "shard on one device")


def make_mesh(data: int = 1, edge: int = 1, device=None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``data`` x ``edge`` mesh whose shards all live on ``device`` (the
    card unless the caller names another). ``devices``, one per shard,
    may be given instead; they must all be the same device."""
    from .. import default_device

    data, edge = int(data), int(edge)
    if data < 1 or edge < 1:
        raise ValueError(f"mesh {data}x{edge}: axis sizes must be >= 1")
    if data > 1:
        raise _unported(f"a data axis of {data} (data parallelism through "
                        "torch.distributed)")
    if devices is None:
        devices = (default_device(device),) * (data * edge)
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != data * edge:
        raise ValueError(f"mesh {data}x{edge} needs {data * edge} devices, "
                         f"got {len(devices)}")
    if len(set(devices)) > 1:
        names = sorted(map(str, set(devices)))
        raise _unported(f"edge shards on several devices {names}")
    mesh = Mesh(data=data, edge=edge, devices=devices)
    logging.getLogger(LOGGER_NAME).info(
        "mesh data=%d x edge=%d: every shard on %s", data, edge,
        devices[0])
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
