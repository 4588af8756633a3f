"""Dataset registry (counterpart of ultra_torchdrug_tpu/data/catalog.py):
the synthetic entries, which need no download. The parsers of the public
datasets are ROADMAP Queue 1 item 8; a config that names one raises in
``lookup``."""

from __future__ import annotations

from ..utils.config import register
from .datasets import (
    JointDataset,
    synthetic_compositional,
    synthetic_inductive,
    synthetic_transductive,
)


@register("SynthKG")
def _synth(path=None, num_nodes=60, num_edges=400, num_relations=7, seed=0,
           **_):
    return synthetic_transductive(
        "SynthKG", num_nodes, num_edges, num_relations, seed
    )


@register("SynthInductiveKG")
def _synth_ind(path=None, num_relations=7, seed=0, **_):
    return synthetic_inductive("SynthInductiveKG", num_relations, seed)


@register("SynthCompositionalKG")
def _synth_comp(path=None, num_nodes=200, seed=0, **_):
    return synthetic_compositional(num_nodes=num_nodes, seed=seed)


@register("SynthJoint")
def _synth_joint(path=None, num_graphs=2, **_):
    return JointDataset(
        "SynthJoint",
        [
            synthetic_transductive(f"synth{i}", 40 + 5 * i, 300, 5, seed=i)
            for i in range(num_graphs)
        ],
    )
