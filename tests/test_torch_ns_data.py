"""The port's Navier–Stokes datasets and draws against the JAX package's,
bit for bit: the ETDRK4 coefficients (``real=True`` and ``False``),
both generators at small grids, and ``ide_cont_navierstokes``' clean
and noisy training draws, the validation draw after them and the
``N_f`` LHS draw.
"""

import os
import sys

import numpy as np
import pytest

from datagen import allencahn_exact as jax_ac
from datagen import navierstokes_exact as jax_exact
from datagen import navierstokes_spectral as jax_spectral
from pinn import data as jax_data
from pinn_torch.datagen import navierstokes_exact, navierstokes_spectral
from pinn_torch.experiments import ide_cont_navierstokes as torch_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import ide_cont_navierstokes
    return ide_cont_navierstokes


def _equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("real", [True, False])
def test_etdrk4_coeffs_bitwise(real):
    k = np.fft.fftfreq(64, d=1.0 / 64)
    Lk = -0.01 * k ** 2 if real else 1j * k ** 3 - 1e-3 * k ** 2
    got = navierstokes_spectral._etdrk4_coeffs(Lk, 2e-3, real=real)
    want = jax_ac._etdrk4_coeffs(Lk, 2e-3, real=real)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nx,ny,nt", [(16, 16, 5), (32, 32, 5), (16, 24, 3)])
def test_spectral_generator_bitwise(nx, ny, nt):
    kw = dict(nx=nx, ny=ny, nt=nt, substeps=8)
    _equal(navierstokes_spectral.generate(**kw), jax_spectral.generate(**kw))


@pytest.mark.parametrize("nx,ny,nt,t_max", [(16, 16, 5, 2.0), (9, 12, 4, 1.5)])
def test_taylor_green_generator_bitwise(nx, ny, nt, t_max):
    kw = dict(nx=nx, ny=ny, nt=nt, t_max=t_max)
    _equal(navierstokes_exact.generate(**kw), jax_exact.generate(**kw))
    t, x, y = np.meshgrid(np.linspace(0, 2, 3), np.linspace(0, 6, 4),
                          np.linspace(0, 6, 5), indexing="ij")
    for g, w in zip(navierstokes_exact.exact_uvp(t, x, y),
                    jax_exact.exact_uvp(t, x, y)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(navierstokes_exact.exact_psi(t, x, y),
                                  jax_exact.exact_psi(t, x, y))


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_training_and_validation_draws_bitwise(jax_exp, noise):
    """One generator a case: the training draw, then the validation
    draw continuing it, then the generator's next numbers."""
    data = navierstokes_spectral.generate(nx=16, ny=16, nt=5, substeps=8)
    rngs = [np.random.default_rng(1234), np.random.default_rng(1234)]
    for n in (300, 200):
        got = torch_exp.sample_training_set(data, n, noise, rngs[0])
        want = jax_exp.sample_training_set(data, n, noise, rngs[1])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(rngs[0].random(4), rngs[1].random(4))


def test_collocation_draw_bitwise():
    """``N_f``'s LHS draw, as the JAX experiment builds it inline
    (``experiments/ide_cont_navierstokes.py:90-100``)."""
    data = navierstokes_exact.generate(nx=8, ny=8, nt=3)
    X = data.X_star[:50]
    got = torch_exp.collocation_set(data, X, 400, 1234)
    rs = np.random.RandomState(1234 + 7919)
    want = np.vstack([X, data.lb + (data.ub - data.lb) * jax_data.lhs(3, 400, rs)])
    np.testing.assert_array_equal(got, want)
