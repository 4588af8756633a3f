"""The weights of a run, drawn on the device from the run's seed in two
calls (one uniform, one normal) and cut into the parameters that a
family's ``param_specs`` lists: linear layers U(±1/√fan_in), embeddings
N(0, 1), layer norms 1 and 0 (PyTorch's defaults). The program and the
reference get the same tensors."""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import seeds


def draw(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = {name: shape for name, shape, _ in specs}

    def fan_in(name):
        return shapes[name.rsplit(".", 1)[0] + ".weight"][1]

    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, "weights"))
    sizes = {kind: sum(math.prod(s) for _, s, k in specs if k == kind)
             for kind in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device),
             "normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device)}
    used = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind in specs:
        if kind in ("ones", "zeros"):
            out[name] = torch.full(shape, 1.0 if kind == "ones" else 0.0,
                                   device=device)
            continue
        n = math.prod(shape)
        part = pools[kind][used[kind]:used[kind] + n].view(shape)
        used[kind] += n
        if kind == "uniform":
            part = (2 * part - 1) / math.sqrt(fan_in(name))
        out[name] = part.clone()
    return out
