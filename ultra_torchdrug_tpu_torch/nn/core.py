"""Small NN building blocks (counterpart of ultra_torchdrug_tpu/nn/core.py).

Modules are plain ``nn.Linear`` / ``nn.LayerNorm`` / ``nn.Embedding``, so the
state-dict keys follow the reference's ``.pth`` schema. ``init_parameters_``
draws every parameter from an explicit generator with torch's default
distributions: Linear weight and bias ~ U(-1/sqrt(fan_in), +), Embedding
~ N(0, 1), LayerNorm scale 1 and bias 0.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-5


class MLP(nn.Module):
    """torchdrug ``layers.MLP``: ReLU between layers, none after the last."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int]):
        super().__init__()
        dims = [in_dim] + list(hidden_dims)
        self.layers = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def layer_norm(module: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, module.normalized_shape, module.weight,
                        module.bias, LAYER_NORM_EPS)


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter of ``module`` from ``generator`` (on the
    generator's device) with torch's default initializers."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / m.in_features ** 0.5
            for p in (m.weight, m.bias):
                p.copy_(torch.empty(p.shape, device=generator.device)
                        .uniform_(-bound, bound, generator=generator))
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.empty(m.weight.shape,
                                       device=generator.device)
                           .normal_(generator=generator))
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
