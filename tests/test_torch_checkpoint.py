"""The port's checkpoints (utils/checkpoint.py) against the JAX package's
(ultra_torchdrug_tpu/utils/checkpoint.py), on the CPU: the reference
``.pth`` importer on the real ``td_ultra_*`` schema with and without DDP's
``module.`` prefix, ``fix_reasoner`` on the ``.pth`` and the native route,
the exact export schema, and both directions between the packages (a JAX
export loads into the port with the JAX model's scores, a port export loads
through the JAX importer into the original tree). Weights are seeded; no
trained checkpoint is read.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_checkpoint import (
    _FakeGraphBuffer,
    make_reference_state_dict,
    td_ultra_schema,
)

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.data.relgraph import (
    build_relation_graph as j_relgraph,
)
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_scores
from ultra_torchdrug_tpu.models.ultra import ultra_init as j_init
from ultra_torchdrug_tpu.utils import checkpoint as j_ckpt
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.data.relgraph import build_relation_graph
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import Ultra
from ultra_torchdrug_tpu_torch.models.ultra import UltraConfig as TUltraConfig
from ultra_torchdrug_tpu_torch.models.ultra import ultra_eval_scores, ultra_init
from ultra_torchdrug_tpu_torch.utils import checkpoint as ckpt
from ultra_torchdrug_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(d=8, layers=2, num_relations=5, num_rel_models=1):
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=d, hidden_dims=(d,) * layers,
                         num_relations=2 * num_relations),
        relation=j_rel_cfg(input_dim=d, hidden=d, num_layers=layers),
        num_rel_models=num_rel_models)
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=d, hidden_dims=(d,) * layers,
                         num_relations=2 * num_relations),
        relation=t_rel_cfg(input_dim=d, hidden=d, num_layers=layers))
    return jcfg, tcfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def _real_schema_file(path, seed, ddp_prefix=False):
    """A td_ultra-like .pth: the real schema's keys and shapes (random
    values), graph buffers and the optimizer's state, as a raw DDP save
    carries them. Returns the state dict written, without the prefix."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(*shape, generator=g)
          for k, shape in td_ultra_schema().items()}
    raw = dict(sd, fact_graph_0=_FakeGraphBuffer(),
               rel_graph_0=_FakeGraphBuffer())
    if ddp_prefix:
        raw = {f"module.{k}": v for k, v in raw.items()}
    opt = {"state": {0: {"step": torch.tensor(1.0),
                         "exp_avg": torch.zeros(64, 128)}},
           "param_groups": [{"lr": 5e-4, "params": [0]}]}
    torch.save({"model": raw, "optimizer": opt}, path)
    return sd


@pytest.mark.parametrize("ddp_prefix", [False, True])
def test_import_real_td_ultra_schema(tmp_path, ddp_prefix):
    """Every live weight of the file lands in the flagship 6x64 model,
    nothing else does and no key is left unmatched; the JAX importer reads
    the same file into the same weights."""
    path = str(tmp_path / "td_ultra_like.pth")
    sd = _real_schema_file(path, 7, ddp_prefix)
    model = ultra_init(TUltraConfig.default(237), seed=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # an unmatched key fails
        got = ckpt.import_torch_checkpoint(path, model.state_dict())
    assert set(got) == set(model.state_dict())
    dead = {"model.dist_embed.weight"} | {k for k in sd if ".model.mlp." in k}
    assert set(sd) - set(got) == dead
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k
    jcfg = JUltraConfig(entity=j_ent_cfg(input_dim=64, hidden_dims=(64,) * 6,
                                         num_relations=474),
                        relation=j_rel_cfg())
    want = j_ckpt.import_torch_checkpoint(
        path, j_init(jax.random.PRNGKey(0), jcfg))
    _assert_state_equal(got, jax_params_to_state_dict(_np(want)))


def test_import_fix_reasoner_pth_route(tmp_path):
    """fix_reasoner on the real schema keeps the current model's relation
    embeddings and projection MLPs and loads every other weight, as the
    JAX importer does."""
    path = str(tmp_path / "td_ultra_like.pth")
    sd = _real_schema_file(path, 3)
    jcfg = JUltraConfig(entity=j_ent_cfg(input_dim=64, hidden_dims=(64,) * 6,
                                         num_relations=474),
                        relation=j_rel_cfg())
    params = j_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(TUltraConfig.default(237)), _np(params))
    current = {k: v.clone() for k, v in model.state_dict().items()}
    got = ckpt.import_torch_checkpoint(path, model.state_dict(),
                                       fix_reasoner=True)
    kept = [k for k in got if ckpt.is_reasoner_key(k)]
    assert len(kept) == 6 * 4 + 6  # 2 projection layers a layer, relation
    for k, v in got.items():
        assert torch.equal(v, current[k] if k in kept else sd[k]), k
    want = j_ckpt.import_torch_checkpoint(path, params, fix_reasoner=True)
    _assert_state_equal(got, jax_params_to_state_dict(_np(want)))


def test_fix_reasoner_native_route_matches_jax(tmp_path):
    """The native route: the saved weights, with the current model's
    reasoner weights kept, as the JAX package's native load does."""
    jcfg, tcfg = _configs()
    saved = j_init(jax.random.PRNGKey(1), jcfg)
    current = j_init(jax.random.PRNGKey(2), jcfg)
    path = str(tmp_path / "model.ckpt")
    ckpt.save_checkpoint(path, load_jax_params(Ultra(tcfg), _np(saved)),
                         {"inner": {}}, 3)
    model = load_jax_params(Ultra(tcfg), _np(current))
    got, opt, epoch = ckpt.load_checkpoint(path, model.state_dict(),
                                           fix_reasoner=True)
    assert (opt, epoch) == ({"inner": {}}, 3)
    j_path = str(tmp_path / "model.pkl")
    j_ckpt.save_checkpoint(j_path, saved)
    want, _, _ = j_ckpt.load_checkpoint(j_path, current, fix_reasoner=True)
    _assert_state_equal(got, jax_params_to_state_dict(_np(want)))
    assert any(ckpt.is_reasoner_key(k) for k in got)
    plain, _, _ = ckpt.load_checkpoint(path, model.state_dict())
    _assert_state_equal(plain, jax_params_to_state_dict(_np(saved)))


def _scores(model, params, jcfg):
    """Both packages' eval scores of 3 queries on SynthKG 40/300/5."""
    jds = j_synth("SynthKG", 40, 300, 5, seed=0)
    tds = t_synth("SynthKG", 40, 300, 5, seed=0)
    q = jds.test[:3]
    jfact = jds.fact_graph(None)[0]
    want = j_scores(params, jcfg, jfact, j_relgraph(jfact),
                    *(jnp.asarray(q[:, i]) for i in range(3)))
    tfact = tds.fact_graph(None)[0]
    b = torch.from_numpy(q.astype(np.int64))
    with torch.inference_mode():
        got = ultra_eval_scores(model, tfact, build_relation_graph(tfact),
                                b[:, 0], b[:, 1], b[:, 2])
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_imported_reference_model_scores(tmp_path):
    """A reference-layout state dict (2x8 towers, random values) drives the
    port's forward pass to the JAX package's scores on the same file."""
    path = str(tmp_path / "ref.pth")
    torch.save({"model": make_reference_state_dict()}, path)
    jcfg, tcfg = _configs()
    model = Ultra(tcfg)
    model.load_state_dict(ckpt.import_torch_checkpoint(path,
                                                       model.state_dict()))
    params = j_ckpt.import_torch_checkpoint(
        path, j_init(jax.random.PRNGKey(0), jcfg))
    got, want = _scores(model, params, jcfg)
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, **SCORE_TOL)


def test_jax_export_loads_into_the_port(tmp_path):
    """A JAX export, loaded into a port model of other weights, scores as
    the JAX model does."""
    jcfg, tcfg = _configs()
    params = j_init(jax.random.PRNGKey(5), jcfg)
    path = str(tmp_path / "jax.pth")
    j_ckpt.export_torch_checkpoint(path, _np(params))
    model = ultra_init(tcfg, seed=9, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model.load_state_dict(ckpt.import_torch_checkpoint(
            path, model.state_dict()))
    got, want = _scores(model, params, jcfg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **SCORE_TOL)


def test_port_export_loads_into_the_jax_tree(tmp_path):
    """The port's export of weights carried from a JAX tree reads back
    through the JAX importer into that tree, leaf for leaf."""
    jcfg, tcfg = _configs()
    params = _np(j_init(jax.random.PRNGKey(3), jcfg))
    path = str(tmp_path / "port.pth")
    ckpt.export_torch_checkpoint(path, load_jax_params(Ultra(tcfg), params))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = j_ckpt.import_torch_checkpoint(
            path, j_init(jax.random.PRNGKey(4), jcfg))
    leaves, tree = jax.tree_util.tree_flatten(params)
    back_leaves, back_tree = jax.tree_util.tree_flatten(_np(back))
    assert tree == back_tree
    for a, b in zip(leaves, back_leaves):
        np.testing.assert_array_equal(a, b)


def test_export_emits_the_exact_real_schema(tmp_path):
    """The export's keys and shapes are the real td_ultra_* inventory, its
    dead entries zeros, its layout {"model", "optimizer": {}}; tensor for
    tensor and key for key in order it is the JAX exporter's file."""
    jcfg = JUltraConfig(entity=j_ent_cfg(input_dim=64, hidden_dims=(64,) * 6,
                                         num_relations=474),
                        relation=j_rel_cfg())
    params = _np(j_init(jax.random.PRNGKey(0), jcfg))
    model = load_jax_params(Ultra(TUltraConfig.default(237)), params)
    path, j_path = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    ckpt.export_torch_checkpoint(path, model)
    j_ckpt.export_torch_checkpoint(j_path, params)
    state = torch.load(path, weights_only=True)
    assert set(state) == {"model", "optimizer"} and state["optimizer"] == {}
    sd, schema = state["model"], td_ultra_schema()
    assert set(sd) == set(schema), set(sd) ^ set(schema)
    for k, shape in schema.items():
        assert tuple(sd[k].shape) == shape and sd[k].dtype == torch.float32
    for k in ("model.dist_embed.weight", "rel_models.0.model.mlp.layers.0.weight",
              "rel_models.0.model.mlp.layers.1.bias"):
        assert not sd[k].any()
    want = torch.load(j_path, weights_only=True)["model"]
    assert list(sd) == list(want)
    _assert_state_equal(sd, want)


def test_a_second_relation_tower_raises(tmp_path):
    """A JAX export of three relation towers (num_rel_models=3) raises on
    a model with one tower, as the JAX importer does, and loads into a
    model with three (every tower's tensors the file's)."""
    jcfg, tcfg = _configs(num_rel_models=3)
    path = str(tmp_path / "multi.pth")
    j_ckpt.export_torch_checkpoint(path, _np(j_init(jax.random.PRNGKey(4),
                                                    jcfg)))
    with pytest.raises(ValueError, match="rel_models.1 but the model has 1 "
                       "relation tower"):
        ckpt.import_torch_checkpoint(path, Ultra(tcfg).state_dict())
    three = Ultra(dataclasses.replace(tcfg, num_rel_models=3)).state_dict()
    got = ckpt.import_torch_checkpoint(path, three)
    sd = torch.load(path)["model"]
    assert {k.split(".")[1] for k in got if k.startswith("rel_models.")} == {
        "0", "1", "2"}
    for k, v in got.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)


def test_import_checks_shapes_and_reports_unknown_keys(tmp_path):
    _, tcfg = _configs()
    template = Ultra(tcfg).state_dict()
    sd = make_reference_state_dict()
    path = str(tmp_path / "ref.pth")
    torch.save(dict(sd, **{"model.extra.weight": torch.zeros(2)}), path)
    with pytest.warns(UserWarning, match=r"model\.extra\.weight"):
        ckpt.import_torch_checkpoint(path, template)
    sd["model.layers.1.linear.bias"] = torch.zeros(9)
    torch.save({"model": sd}, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.import_torch_checkpoint(path, template)
    sd = make_reference_state_dict(num_entity_layers=3)
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="model.layers.2"):
        ckpt.import_torch_checkpoint(path, template)
