"""Port parity of the paper models: every model of MODEL_ZOO, given the
reference's initial parameters through ``params_from_jax``, computes the
reference's logits (fp32 CPU, atol/rtol 1e-5) and gradients, and its flat
parameter vector equals the reference's ``flatten_pytree`` (the global
top-k depends on that order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import flatten_pytree as ref_flatten
from repro.models.paper_models import MODEL_ZOO as REF_ZOO
from repro_torch.core.compression import flatten_pytree
from repro_torch.fed.loop import _cross_entropy
from repro_torch.models import MODEL_ZOO, params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

INPUTS = {"logreg": (784,), "mlp": (784,), "cnn": (32, 32, 3),
          "lstm": (28, 28)}


def _setup(name, batch=3, seed=0):
    ref_params = jax.tree.map(np.asarray,
                              REF_ZOO[name][0](jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed).standard_normal(
        (batch,) + INPUTS[name]).astype(np.float32)
    return ref_params, x


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_forward_matches_reference(name):
    ref_params, x = _setup(name)
    want = np.asarray(REF_ZOO[name][1](
        jax.tree.map(jnp.asarray, ref_params), jnp.asarray(x)))
    with torch.no_grad():
        got = MODEL_ZOO[name][1](params_from_jax(ref_params),
                                 torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_flat_vector_order_matches_reference(name):
    ref_params, _ = _setup(name)
    want, _ = ref_flatten(jax.tree.map(jnp.asarray, ref_params))
    got, _ = flatten_pytree(params_from_jax(ref_params))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_gradient_matches_reference(name):
    """The local-SGD step's gradient, flattened in the shared leaf order."""
    ref_params, x = _setup(name, batch=4, seed=1)
    y = np.arange(4, dtype=np.int32) % 10

    def ref_loss(p):
        logits = REF_ZOO[name][1](p, jnp.asarray(x))
        logz = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(logz - logits[jnp.arange(4), jnp.asarray(y)])

    g_ref = jax.grad(ref_loss)(jax.tree.map(jnp.asarray, ref_params))
    want, _ = ref_flatten(g_ref)
    got = torch.func.grad(lambda p: _cross_entropy(
        MODEL_ZOO[name][1](p, torch.from_numpy(x)),
        torch.from_numpy(y.astype(np.int64))))(params_from_jax(ref_params))
    got, _ = flatten_pytree(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("name", sorted(MODEL_ZOO))
def test_init_shapes_match_reference(name):
    """The port's own generator-seeded init has the reference's layout."""
    ref_params, _ = _setup(name)
    params = MODEL_ZOO[name][0](torch.Generator().manual_seed(0))
    ref_leaves = jax.tree.leaves(ref_params)
    _, spec = flatten_pytree(params)
    assert [shape for shape, _ in spec[1]] == [l.shape for l in ref_leaves]
    assert all(dtype == torch.float32 for _, dtype in spec[1])
