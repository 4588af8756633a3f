"""The conv's activations (``ConvConfig.activation``) against ``jax.nn``
on the CPU: the port's table holds exactly the ``jax.nn`` functions that
keep the shape of a [V, B, out] tensor under their default arguments, each
agrees with its ``jax.nn`` function in value and gradient, and a conv layer
with it agrees with the JAX package's ``conv_apply``. Any other name raises
a ValueError that names it.

Tolerances: the function and its gradient 1e-5 relative + 1e-5 absolute
on inputs and cotangents of order 1-10 (fp32, the same formulas; torch's
kernels and backward formulas round differently, e.g. gelu's gradient by
up to 1.4e-6 near 0; NaN where both are NaN, as log1mexp below 0); a conv
layer 1e-5, as tests/test_torch_ultra.py's.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultra_torchdrug_tpu.data.graph import Graph as JGraph
from ultra_torchdrug_tpu.models.layers import ConvConfig as JConvConfig
from ultra_torchdrug_tpu.models.layers import conv_apply as j_conv
from ultra_torchdrug_tpu.models.layers import conv_init
from ultra_torchdrug_tpu_torch.data.graph import Graph
from ultra_torchdrug_tpu_torch.models.layers import (
    ACTIVATIONS,
    ConvConfig,
    GeneralizedRelationalConv,
    activation_fn,
    conv_apply,
)

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
V, B, D, R, E = 12, 3, 8, 3, 40


def _shape_keeping_jax_names():
    x = jnp.zeros((V, B, D), jnp.float32) + 0.5
    names = []
    for name in dir(jax.nn):
        f = getattr(jax.nn, name)
        if name.startswith("_") or not callable(f) or inspect.isclass(f):
            continue
        try:
            y = f(x)
        except Exception:  # needs more arguments
            continue
        if getattr(y, "shape", None) == x.shape:
            names.append(name)
    return sorted(names)


def test_table_is_jax_nn_shape_keeping_functions():
    assert sorted(ACTIVATIONS) == _shape_keeping_jax_names()


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_matches_jax(name):
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(V, B, D))).astype(np.float32)
    cot = rng.normal(size=(V, B, D)).astype(np.float32)
    f = getattr(jax.nn, name)
    want, vjp = jax.vjp(f, jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    got = activation_fn(name)(xt)
    (grad,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **TOL)

    # one conv layer with the activation after its layer norm
    ccfg = dict(input_dim=D, output_dim=D, num_relations=R,
                query_input_dim=D, message_func="distmult",
                aggregate_func="sum", layer_norm=True, activation=name,
                rel_mode="embedding")
    params = conv_init(jax.random.PRNGKey(1), JConvConfig(**ccfg,
                                                          rspmm_impl="xla"))
    layer = GeneralizedRelationalConv(ConvConfig(**ccfg))
    layer.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in (
        ("linear.weight", params["linear"]["w"].T),
        ("linear.bias", params["linear"]["b"]),
        ("layer_norm.weight", params["layer_norm"]["scale"]),
        ("layer_norm.bias", params["layer_norm"]["bias"]),
        ("relation.weight", params["relation"]["weight"]))})
    tri = np.stack([rng.integers(0, V, E), rng.integers(0, V, E),
                    rng.integers(0, R, E)], 1)
    jg = JGraph.from_triplets(tri.astype(np.int32), V, R)
    h = rng.normal(size=(V, B * D)).astype(np.float32)
    bnd = rng.normal(size=(V, B * D)).astype(np.float32)
    want_h = j_conv(params, JConvConfig(**ccfg, rspmm_impl="xla"), jg,
                    jnp.asarray(h), jnp.asarray(bnd))
    with torch.inference_mode():
        got_h = conv_apply(layer, Graph.from_triplets(tri, V, R),
                           torch.from_numpy(h), torch.from_numpy(bnd))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **CONV_TOL)


@pytest.mark.parametrize("name", [None, "", "none"])
def test_no_activation_is_the_identity(name):
    x = torch.randn(4, 2, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(activation_fn(name)(x), x)


@pytest.mark.parametrize("name", ["glu", "logsumexp", "one_hot", "Relu"])
def test_other_names_raise(name):
    with pytest.raises(ValueError, match=f"activation={name!r}"):
        GeneralizedRelationalConv(ConvConfig(
            input_dim=D, output_dim=D, num_relations=R, query_input_dim=D,
            activation=name))
