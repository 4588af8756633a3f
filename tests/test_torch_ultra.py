"""The PyTorch port's conv layer, towers and ULTRA scores against the JAX
package, on the same weights (``ultra_init(PRNGKey(0))`` carried across by
``load_jax_params``) and the same seeded inputs, at the tiny 3x16 size of
__graft_entry__.py.

Tolerances: 1e-5 for one conv layer (fp32, other summation order);
1e-4 for whole towers and scores, where the rounding of six stacked layers
(norms, matmuls, sums) adds up.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.datasets import synthetic_transductive as j_synth
from ultra_torchdrug_tpu.data.relgraph import build_relation_graph as j_relgraph
from ultra_torchdrug_tpu.models.layers import conv_apply as j_conv
from ultra_torchdrug_tpu.models.nbfnet import (
    entity_nbfnet_config as j_ent_cfg,
    rel_nbfnet_apply as j_rel_apply,
    rel_nbfnet_config as j_rel_cfg,
)
from ultra_torchdrug_tpu.models.ultra import UltraConfig as JUltraConfig
from ultra_torchdrug_tpu.models.ultra import ultra_eval_scores as j_scores
from ultra_torchdrug_tpu.models.ultra import ultra_init
from ultra_torchdrug_tpu_torch.data.datasets import (
    synthetic_transductive as t_synth,
)
from ultra_torchdrug_tpu_torch.data.relgraph import (
    build_relation_graph as t_relgraph,
)
from ultra_torchdrug_tpu_torch.models.layers import conv_apply as t_conv
from ultra_torchdrug_tpu_torch.models.nbfnet import (
    entity_nbfnet_config as t_ent_cfg,
    rel_nbfnet_apply as t_rel_apply,
    rel_nbfnet_config as t_rel_cfg,
)
from ultra_torchdrug_tpu_torch.models.ultra import (
    Ultra,
    UltraConfig as TUltraConfig,
    ultra_eval_scores as t_scores,
    ultra_init as t_ultra_init,
)
from ultra_torchdrug_tpu_torch.utils.convert import load_jax_params

DIM, LAYERS, NUM_REL = 16, 3, 5
TOWER_TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(impl="xla"):
    jcfg = JUltraConfig(
        entity=j_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * LAYERS,
                         num_relations=2 * NUM_REL, rspmm_impl=impl),
        relation=j_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=LAYERS,
                           rspmm_impl=impl),
    )
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * LAYERS,
                         num_relations=2 * NUM_REL),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=LAYERS),
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jds = j_synth("graft", 48, 320, NUM_REL, seed=0)
    tds = t_synth("graft", 48, 320, NUM_REL, seed=0)
    jfact, train = jds.fact_graph(None)
    tfact, _ = tds.fact_graph(None)
    jcfg, tcfg = _configs()
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    return dict(jfact=jfact, tfact=tfact, jrel=j_relgraph(jfact),
                trel=t_relgraph(tfact), train=train, params=params,
                model=model, jcfg=jcfg)


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a) if dtype is None
                            else np.asarray(a).astype(dtype))


@pytest.mark.parametrize("dense", [False, True])
def test_conv_embedding_mode(setup, rng, dense):
    jrel, trel = setup["jrel"], setup["trel"]
    if dense:
        jrel, trel = jrel.prepare_dense(), trel.prepare_dense()
        assert trel.dense_adj is not None
    B, V = 3, trel.num_nodes
    x = rng.normal(size=(V, B * DIM)).astype(np.float32)
    bnd = rng.normal(size=(V, B * DIM)).astype(np.float32)
    jl = setup["params"]["relation"]["layers"][0]
    want = j_conv(jl, setup["jcfg"].relation.layer_configs()[0], jrel,
                  jnp.asarray(x), jnp.asarray(bnd))
    layer = setup["model"].rel_models[0].model.layers[0]
    with torch.inference_mode():
        got = t_conv(layer, trel, _t(x), _t(bnd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_conv_injected_project_mode(setup, rng):
    jund = setup["jfact"].undirected_with_inverse()
    tund = setup["tfact"].undirected_with_inverse()
    B, V = 3, tund.num_nodes
    x = rng.normal(size=(V, B, DIM)).astype(np.float32)  # 3-D form
    bnd = rng.normal(size=(V, B, DIM)).astype(np.float32)
    rel_inj = rng.normal(size=(B, 2 * NUM_REL, DIM)).astype(np.float32)
    jl = setup["params"]["entity"]["layers"][1]
    want = j_conv(jl, setup["jcfg"].entity.layer_configs()[1], jund,
                  jnp.asarray(x), jnp.asarray(bnd),
                  rel_injected=jnp.asarray(rel_inj))
    layer = setup["model"].model.layers[1]
    with torch.inference_mode():
        got = t_conv(layer, tund, _t(x), _t(bnd), rel_injected=_t(rel_inj))
    assert got.shape == (V, B, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dense", [False, True])
def test_rel_nbfnet_apply(setup, dense):
    jrel, trel = setup["jrel"], setup["trel"]
    if dense:
        jrel, trel = jrel.prepare_dense(), trel.prepare_dense()
    q = setup["train"][:6, 2]
    want = j_rel_apply(setup["params"]["relation"], setup["jcfg"].relation,
                       jrel, jnp.asarray(q))
    with torch.inference_mode():
        got = t_rel_apply(setup["model"].rel_models[0].model, trel,
                          _t(q, np.int64))
    assert got.shape == (6, 2 * NUM_REL, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOWER_TOL)


def _port_scores(model, tfact, trel, batch):
    b = _t(batch, np.int64)
    with torch.inference_mode():
        t, h = t_scores(model, tfact, trel, b[:, 0], b[:, 1], b[:, 2])
    return t.numpy(), h.numpy()


@pytest.mark.parametrize("rel_route", ["dense", "sparse"])
def test_ultra_eval_scores(setup, rel_route):
    jrel, trel = setup["jrel"], setup["trel"]
    if rel_route == "dense":
        jrel, trel = jrel.prepare_dense(), trel.prepare_dense()
        assert trel.dense_adj is not None
    else:
        # max_bytes=0 keeps the relation graph on the sparse rspmm
        jrel = jrel.prepare_dense(max_bytes=0)
        trel = trel.prepare_dense(max_bytes=0)
        assert trel.dense_adj is None
    batch = setup["train"][:8]
    jt, jh = j_scores(setup["params"], setup["jcfg"], setup["jfact"], jrel,
                      *(jnp.asarray(batch[:, i]) for i in range(3)))
    tt, th = _port_scores(setup["model"], setup["tfact"], trel, batch)
    assert tt.shape == th.shape == (8, setup["tfact"].num_nodes)
    np.testing.assert_allclose(tt, np.asarray(jt), **TOWER_TOL)
    np.testing.assert_allclose(th, np.asarray(jh), **TOWER_TOL)


def test_ultra_eval_scores_vs_pallas_interpret():
    """The JAX side on its Pallas kernels (interpret mode), smallest size."""
    jds = j_synth("tiny", 20, 80, 3, seed=1)
    tds = t_synth("tiny", 20, 80, 3, seed=1)
    jfact, train = jds.fact_graph(None)
    tfact, _ = tds.fact_graph(None)
    jcfg, _ = _configs(impl="pallas")
    jcfg = dataclasses.replace(
        jcfg,
        entity=dataclasses.replace(jcfg.entity, num_relations=6,
                                   hidden_dims=(DIM,) * 2),
        relation=dataclasses.replace(jcfg.relation, hidden_dims=(DIM,) * 2))
    tcfg = TUltraConfig(
        entity=t_ent_cfg(input_dim=DIM, hidden_dims=(DIM,) * 2,
                         num_relations=6),
        relation=t_rel_cfg(input_dim=DIM, hidden=DIM, num_layers=2))
    params = ultra_init(jax.random.PRNGKey(0), jcfg)
    model = load_jax_params(Ultra(tcfg),
                            jax.tree_util.tree_map(np.asarray, params))
    jund = jfact.undirected_with_inverse().prepare_pallas()
    jrel = j_relgraph(jfact).prepare_pallas()
    batch = train[:4]
    jt, jh = j_scores(params, jcfg, jfact, jrel,
                      *(jnp.asarray(batch[:, i]) for i in range(3)),
                      fact_graph_und=jund)
    tt, th = _port_scores(model, tfact, t_relgraph(tfact), batch)
    np.testing.assert_allclose(tt, np.asarray(jt), **TOWER_TOL)
    np.testing.assert_allclose(th, np.asarray(jh), **TOWER_TOL)


def test_load_jax_params_rejects_mismatch(setup):
    tree = jax.tree_util.tree_map(np.asarray, setup["params"])
    _, tcfg = _configs()
    model = Ultra(tcfg)
    del tree["entity"]["mlp"]["layers"][1]
    with pytest.raises(KeyError):
        load_jax_params(model, tree)
    tree = jax.tree_util.tree_map(np.asarray, setup["params"])
    tree["entity"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        load_jax_params(model, tree)


def test_state_dict_keys_follow_reference_schema():
    _, tcfg = _configs()
    keys = set(t_ultra_init(tcfg, seed=0, device="cpu").state_dict())
    for key in ("model.layers.0.linear.weight",
                "model.layers.2.layer_norm.bias",
                "model.layers.1.relation_projection.layers.1.weight",
                "model.mlp.layers.1.bias",
                "rel_models.0.model.layers.0.relation.weight",
                "rel_models.0.model.layers.2.linear.weight"):
        assert key in keys, key


def test_seeded_init_is_reproducible():
    _, tcfg = _configs()
    a = t_ultra_init(tcfg, seed=7, device="cpu").state_dict()
    b = t_ultra_init(tcfg, seed=7, device="cpu").state_dict()
    c = t_ultra_init(tcfg, seed=8, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.layers.0.linear.weight"],
                           c["model.layers.0.linear.weight"])


def test_rel_inputs_ones(setup):
    from ultra_torchdrug_tpu.models.rel_inputs import (
        build_initial_features as j_features,
    )
    from ultra_torchdrug_tpu_torch.models.rel_inputs import (
        build_initial_features as t_features,
    )

    want = j_features(jax.random.PRNGKey(0), setup["jrel"], "ones", DIM)
    got = t_features(setup["trel"], "ones", DIM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ones plus glorot's U(-s, s), s = sqrt(6 / (V + D)): the draw is the
    # port's own, so its shape and bound are held, not its values
    V = setup["trel"].num_nodes
    both = t_features(setup["trel"], "ones__glorot", DIM,
                      generator=torch.Generator().manual_seed(0))
    scale = (6.0 / (V + DIM)) ** 0.5
    assert both.shape == (V, DIM)
    assert (both - 1).abs().max() <= scale and (both - 1).abs().max() > 0
