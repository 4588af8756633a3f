"""Carry a JAX-package parameter tree (as ``ultra_init`` or
``classic_nbfnet_init`` builds it, leaves as numpy arrays) into the port's
``Ultra`` or ``ClassicNBFNet`` module.

Tree paths map onto the reference's state-dict keys:

    entity.layers[i].linear.{w, b}             -> model.layers.{i}.linear.{weight^T, bias}
    entity.layers[i].layer_norm.{scale, bias}  -> model.layers.{i}.layer_norm.{weight, bias}
    entity.layers[i].relation_projection.layers[j].{w, b}
                                               -> model.layers.{i}.relation_projection.layers.{j}.*
    entity.mlp.layers[j].{w, b}                -> model.mlp.layers.{j}.*
    relation.layers[i].{linear, layer_norm, relation.weight}
                                               -> rel_models.0.model.layers.{i}.*

and for classic NBFNet (the reference's NBFNet keys):

    layers[i].{linear, layer_norm, relation_linear}  -> layers.{i}.*
    query.weight                               -> query.weight
    mlp.layers[j].{w, b}                       -> mlp.layers.{j}.*

``w`` is [in, out] in the JAX tree and transposed to nn.Linear's [out, in].
Keys present on one side only raise.
"""

from __future__ import annotations

import numpy as np
import torch

_ROOTS = {"entity": "model", "relation": "rel_models.0.model",
          "layers": "layers", "query": "query", "mlp": "mlp"}
_LEAVES = {"w": "weight", "b": "bias", "scale": "weight"}


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def jax_params_to_state_dict(params) -> dict:
    """The JAX tree as a torch state dict with the reference's keys."""
    state = {}
    for path, value in _flatten(params):
        root, _, rest = path.partition(".")
        if root not in _ROOTS:
            raise KeyError(f"unexpected parameter {path!r}")
        *head, leaf = rest.split(".")
        if leaf == "w":
            value = value.T
        key = ".".join([_ROOTS[root], *head, _LEAVES.get(leaf, leaf)])
        state[key] = torch.tensor(np.asarray(value, np.float32))
    return state


def load_jax_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load the JAX tree ``params`` into ``model`` in place; returns it."""
    state = jax_params_to_state_dict(params)
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        raise KeyError(f"parameter mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f"shape mismatch for {key}: JAX "
                             f"{tuple(value.shape)} vs {tuple(want[key].shape)}")
    model.load_state_dict(state)
    return model
