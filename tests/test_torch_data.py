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


def _assert_same_draw(seed, got_fn, want_fn):
    """Same global seed, same call order: every array equal, and the
    global stream left in the same place."""
    np.random.seed(seed)
    got = got_fn()
    got_next = np.random.rand(3)
    np.random.seed(seed)
    want = want_fn()
    want_next = np.random.rand(3)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(got_next, want_next)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_burgers_cont_identification_equal(noise):
    _assert_same_draw(
        1234, lambda: data.burgers_cont_identification(2000, noise=noise),
        lambda: jax_data.burgers_cont_identification(2000, noise=noise))


@pytest.mark.parametrize("n_0,n_b,n_f", [(50, 50, 20000), (30, 30, 600)])
def test_schrodinger_inference_equal(n_0, n_b, n_f):
    _assert_same_draw(1234, lambda: data.schrodinger_inference(n_0, n_b, n_f),
                      lambda: jax_data.schrodinger_inference(n_0, n_b, n_f))


@pytest.mark.parametrize("q", [1, 8, 50, 81, 100, 500])
def test_irk_tableaux_equal(q):
    got, want = irk.gauss_legendre_irk(q), jax_irk.gauss_legendre_irk(q)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(irk.irk_weights(q), jax_irk.irk_weights(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("noise", [0.0, 0.01])
@pytest.mark.parametrize("n_n,q", [(250, 500), (50, 8)])
def test_burgers_disc_inference_equal(n_n, q, noise):
    lb, ub = np.array([-1.0]), np.array([1.0])
    _assert_same_draw(
        1234, lambda: data.burgers_disc_inference(n_n, q, lb, ub, 10, 90,
                                                  noise=noise),
        lambda: jax_data.burgers_disc_inference(n_n, q, lb, ub, 10, 90,
                                                noise=noise))


@pytest.mark.parametrize("noise", [0.0, 0.01])
@pytest.mark.parametrize("n_0,n_1", [(199, 201), (40, 40)])
def test_burgers_disc_identification_equal(n_0, n_1, noise):
    """The grid-wide choice(N, None) is consumed first on both sides;
    q = 81 from irk.auto_stages(0.8)."""
    got = None

    def port():
        nonlocal got
        got = data.burgers_disc_identification(n_0, n_1, 10, 90, noise=noise)
        return got

    _assert_same_draw(1234, port, lambda: jax_data.burgers_disc_identification(
        n_0, n_1, 10, 90, noise=noise))
    assert got.q == 81 and got.IRK_alpha.shape == (81, 81)


def test_disc_identification_noisy_case_continues_the_stream():
    """The experiments draw the clean case, then the noisy one, from one
    seed: the second draw equals JAX's second draw."""
    draws = []
    for mod in (data, jax_data):
        np.random.seed(1234)
        mod.burgers_disc_identification(199, 201, 10, 90)
        draws.append(mod.burgers_disc_identification(199, 201, 10, 90,
                                                     noise=0.01))
    for name, a, b in zip(draws[0]._fields, *draws):
        np.testing.assert_array_equal(a, b, err_msg=name)
