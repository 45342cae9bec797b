"""The port's numpy data prep and IRK tableaux equal the JAX package's,
bit for bit, from the same seeds."""

import numpy as np
import pytest

from pinn import data as jax_data
from pinn import irk as jax_irk
from pinn_torch import data, irk


@pytest.mark.parametrize("n,samples,seed", [(2, 100, 0), (2, 1017, 5),
                                            (3, 64, 11)])
def test_lhs_equal(n, samples, seed):
    got = data.lhs(n, samples, np.random.RandomState(seed))
    want = jax_data.lhs(n, samples, np.random.RandomState(seed))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_u,n_f,seed", [(100, 10000, 1234), (7, 1017, 3)])
def test_burgers_cont_inference_equal(n_u, n_f, seed):
    """Same global seed, same call order: every array equal."""
    np.random.seed(seed)
    got = data.burgers_cont_inference(n_u, n_f)
    got_next = np.random.rand(3)
    np.random.seed(seed)
    want = jax_data.burgers_cont_inference(n_u, n_f)
    want_next = np.random.rand(3)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # and the global stream is left in the same place
    np.testing.assert_array_equal(got_next, want_next)


@pytest.mark.parametrize("q", [1, 8, 100])
def test_irk_tableaux_equal(q):
    got, want = irk.gauss_legendre_irk(q), jax_irk.gauss_legendre_irk(q)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(irk.irk_weights(q), jax_irk.irk_weights(q)):
        np.testing.assert_array_equal(a, b)
