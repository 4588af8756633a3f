"""Checkpoints (counterpart of ultra_torchdrug_tpu/utils/checkpoint.py): the
port's native format, and the reference's torch ``.pth`` layout in both
directions.

The port's modules carry the reference's state-dict keys
(``utils/convert.py``), so a ``.pth`` is a filtered state dict: no key is
renamed and no weight transposed. Of a real ``td_ultra_*`` checkpoint's keys
(the task module tree: MultiGraphPreTraining wrapping TransferNBFNet and a
RelationModelList of RelNBFNet), these are live and loaded, each checked
against the model's shape:

    model.layers.{i}.{linear, layer_norm}.{weight, bias}
    model.layers.{i}.relation_projection.layers.{j}.{weight, bias}
    model.mlp.layers.{j}.{weight, bias}
    rel_models.{t}.model.layers.{i}.{linear, layer_norm}.{weight, bias}
    rel_models.{t}.model.layers.{i}.relation.weight
    rel_models.{t}.model.learnable_q.weight   (only where the model has one)

and these are dead in the reference's forward, or environment, and dropped:
``model.dist_embed.weight``, the relation tower's scoring MLP
``rel_models.{t}.model.mlp.*``, any ``*graph*`` buffer, ``query.weight``,
every non-tensor value, the optimizer state and DDP's ``module.`` prefix.
Any other key is reported in one warning. Tower t is loaded for every t
below the model's tower count (``num_rel_models``); a tower beyond it
raises. The exporter writes every tower with its dead scoring MLP and, as
the JAX package's exporter, no ``learnable_q``.

``fix_reasoner`` (frozen-reasoner fine-tuning) keeps the current model's
relation projections, relation linears, ``relation.weight`` and
``query.weight`` and loads everything else, on both routes.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, Optional, Tuple

import torch

_REASONER_PATTERNS = ("relation.weight", "relation_projection",
                      "relation_linear", "query.weight")
_LIVE = re.compile(
    r"model\.(layers\.\d+\.(linear|layer_norm|relation_projection\.layers\.\d+)"
    r"\.(weight|bias)|mlp\.layers\.\d+\.(weight|bias))"
    r"|rel_models\.(?P<tower>\d+)\.model\.(layers\.\d+\.(linear\.(weight|bias)"
    r"|layer_norm\.(weight|bias)|relation\.weight)|learnable_q\.weight)")
_DEAD = re.compile(r"dist_embed|rel_models\.\d+\.model\.mlp|graph|query\.weight")


def is_reasoner_key(key: str) -> bool:
    """The keys that ``fix_reasoner`` keeps from the current model."""
    return any(p in key for p in _REASONER_PATTERNS)


def keep_reasoner_weights(loaded: Dict[str, torch.Tensor],
                          current: Dict[str, torch.Tensor]) -> dict:
    """``loaded`` with its reasoner weights replaced by ``current``'s."""
    return {k: current[k] if is_reasoner_key(k) else v
            for k, v in loaded.items()}


def import_torch_checkpoint(path: str, template: Dict[str, torch.Tensor],
                            fix_reasoner: bool = False) -> dict:
    """The reference ``.pth`` at ``path`` as a state dict for the model
    whose state dict is ``template``: the template's tensors with every live
    key of the file in place (each on the template's device and dtype), the
    reasoner weights left as they are under ``fix_reasoner``."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    sd = state["model"] if isinstance(state, dict) and "model" in state \
        else state
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    towers = len({m.group(1) for k in template
                  if (m := re.match(r"rel_models\.(\d+)\.", k))})
    out = dict(template)
    unmatched = []
    for key, value in sd.items():
        if not isinstance(value, torch.Tensor):
            continue
        if fix_reasoner and is_reasoner_key(key):
            continue
        live = _LIVE.fullmatch(key)
        if live is None:
            if not _DEAD.search(key):
                unmatched.append(key)
            continue
        tower = live.group("tower")
        if tower is not None and int(tower) >= towers:
            raise ValueError(f"checkpoint has rel_models.{tower} but the "
                             f"model has {towers} relation tower(s)")
        if key.endswith("learnable_q.weight") and key not in template:
            continue  # learn_query configs only
        if key not in template:
            raise KeyError(f"checkpoint key {key} has no counterpart in the "
                           "model")
        want = template[key]
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(value.shape)} vs {tuple(want.shape)}")
        out[key] = value.detach().to(device=want.device, dtype=want.dtype)
    if unmatched:
        warnings.warn(f"unmatched checkpoint keys: {unmatched}")
    return out


def export_torch_checkpoint(path: str, model: torch.nn.Module) -> str:
    """Write an ULTRA model as a reference-layout ``.pth``:
    ``{"model": state_dict, "optimizer": {}}`` with fp32 CPU tensors, the
    inverse of ``import_torch_checkpoint``. The dead reference parameters
    that have no counterpart (``model.dist_embed.weight`` [10, D], each
    relation tower's scoring MLP [2H, 2H] and [H, 2H]) are written as zeros,
    so that strict loaders find every key. A ``learnable_q`` is not
    written, as the JAX package's exporter writes none."""
    state = {k: v.detach().to("cpu", torch.float32).clone()
             for k, v in model.state_dict().items()}
    sd = {k: v for k, v in state.items() if k.startswith("model.")}
    d = state["model.layers.0.linear.weight"].shape[0]
    sd["model.dist_embed.weight"] = torch.zeros(10, d)
    towers = sorted({int(m.group(1)) for k in state
                     if (m := re.match(r"rel_models\.(\d+)\.", k))})
    for t in towers:
        prefix = f"rel_models.{t}.model."
        sd.update((k, v) for k, v in state.items() if k.startswith(prefix)
                  and not k.endswith("learnable_q.weight"))
        last = max(int(m.group(1)) for k in state if (m := re.match(
            re.escape(prefix) + r"layers\.(\d+)\.linear\.weight$", k)))
        hid = state[f"{prefix}layers.{last}.linear.weight"].shape[0]
        sd[f"{prefix}mlp.layers.0.weight"] = torch.zeros(2 * hid, 2 * hid)
        sd[f"{prefix}mlp.layers.0.bias"] = torch.zeros(2 * hid)
        sd[f"{prefix}mlp.layers.1.weight"] = torch.zeros(hid, 2 * hid)
        sd[f"{prefix}mlp.layers.1.bias"] = torch.zeros(hid)
    torch.save({"model": sd, "optimizer": {}}, path)
    return path


def save_checkpoint(path: str, model: torch.nn.Module, optimizer_state: dict,
                    epoch: int) -> None:
    """The native format: ``torch.save`` of the model's state dict, the
    optimizer's state and the epoch."""
    torch.save({"model": model.state_dict(), "optimizer": optimizer_state,
                "epoch": epoch}, path)


def load_checkpoint(path: str, template: Dict[str, torch.Tensor],
                    fix_reasoner: bool = False, map_location=None
                    ) -> Tuple[dict, Optional[dict], Optional[int]]:
    """(model state dict, optimizer state, epoch) of a checkpoint: a path
    ending in ``.pth`` is a reference checkpoint (``import_torch_checkpoint``;
    it has no optimizer state or epoch, so both are None), any other a
    native one that ``save_checkpoint`` wrote. ``fix_reasoner`` keeps
    ``template``'s reasoner weights on both routes."""
    if str(path).endswith(".pth"):
        return import_torch_checkpoint(path, template, fix_reasoner), None, None
    state = torch.load(path, map_location=map_location, weights_only=True)
    sd = state["model"]
    if fix_reasoner:
        sd = keep_reasoner_weights(sd, template)
    return sd, state["optimizer"], state["epoch"]
