"""Operands of the edge paths between a data row's home device and its
shards' devices (parallel/mesh.py).

The partitioned path and the ``xla`` body are each one autograd node whose
inputs and outputs live on the home device, shard 0's: inside it, shard s
works on ``devices[s]``, the operands that every shard reads are copied to
each shard device once (``replicate``) and the shards' partials are
summed on the home (``sum_home``). The ring keeps its node states on the
shards' cards instead (parallel/card_rows.py, whose ``CardLayout.cut``
takes a home tensor's row blocks with ``blocks_on``); only its relation
operand and its d_relation partials pass through the home. Where a shard's
device is the home, its block is a view and nothing is copied, so that
with every shard on one device the paths run exactly the single-device
schedule. The copies are PyTorch's: between two cards they are ordered on
both cards' current streams and never block the host, so the shards'
cards overlap.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def indexed(device) -> torch.device:
    """``device`` as a torch.device, "cuda" without an index as the current
    card, so that a shard's device compares equal to its tensors'."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_devices(devices: Sequence, home: torch.device) -> tuple:
    """The shards' ``devices`` (a layout's or the mesh's) as a tuple.
    Raises when the home operands do not lie on shard 0's device."""
    devices = tuple(devices)
    if devices[0] != home:
        raise ValueError(f"the operands lie on {home}, but the shards' home "
                         f"(shard 0's device) is {devices[0]}")
    return devices


def replicate(t: torch.Tensor, devices: Sequence) -> dict:
    """``t`` on each distinct device of ``devices``: {device: tensor}, ``t``
    itself on its own device. The copies fan out as a tree: every device
    that holds a copy sends the next one, so the home sends to one device
    in the first round, two devices send in the second, and so on."""
    out = {t.device: t}
    missing = [d for d in dict.fromkeys(devices) if d not in out]
    while missing:
        for src in list(out):
            if not missing:
                break
            dst = missing.pop(0)
            out[dst] = out[src].to(dst)
    return out


def blocks_on(full: torch.Tensor, v_block: int, devices: Sequence) -> list:
    """The row blocks of ``full`` [n * v_block, ...], block s on
    ``devices[s]``: a view where that is ``full``'s device, else a copy."""
    return [full[s * v_block:(s + 1) * v_block].to(d)
            for s, d in enumerate(devices)]


def zero_partial(parts: dict, like: torch.Tensor,
                 shape=None) -> torch.Tensor:
    """The zero-initialised partial of ``like``'s device in ``parts``
    ({device: tensor}), of ``shape`` (``like``'s by default), made at first
    use."""
    if like.device not in parts:
        parts[like.device] = like.new_zeros(like.shape if shape is None
                                            else shape)
    return parts[like.device]


def add_partial(parts: dict, device, partial: torch.Tensor) -> None:
    """Accumulate ``partial`` into ``parts[device]`` (in place after the
    first)."""
    if device in parts:
        parts[device].add_(partial)
    else:
        parts[device] = partial


def sum_home(parts: dict, home: torch.device) -> Optional[torch.Tensor]:
    """The sum of per-device partials {device: tensor} on ``home``: the
    home's own partial first, then each other device's in the order they
    were added (the JAX package's psum). None when there is none."""
    total = parts.get(home)
    for d, p in parts.items():
        if d == home:
            continue
        total = p.to(home) if total is None else total.add_(p.to(home))
    return total
