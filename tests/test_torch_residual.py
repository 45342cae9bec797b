"""The port's residual evaluation (pinn_torch.ops.residual) against the
JAX package's fused residual kernels (pinn.ops.pallas_residual,
interpret mode), on seed-made numpy weights and points.

On the CPU each wrapper runs its kernel's plain version (the TPU
kernel's arithmetic on tensors, normalisation in the function), so
these tests check everything but the kernel body.  Bars are those of
tests/test_pallas.py: Burgers rtol 2e-5 / atol 1e-6, Schrödinger rtol
2e-4 / atol 2e-6 (float32 summed in another order on each side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.ops import pallas_residual
from pinn_torch.ops import residual
from pinn_torch.problems import burgers, schrodinger
from pinn_torch.utils import trace
from pinn_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(1)

LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)
S_LB = np.array([-5.0, 0.0], np.float32)
S_UB = np.array([5.0, np.pi / 2], np.float32)
FLAGSHIP = [2] + [20] * 8 + [1]


def _case(layers, n, lb, ub, seed):
    rng = np.random.RandomState(seed)
    pairs = [((rng.randn(a, b) * np.sqrt(2.0 / (a + b))).astype(np.float32),
              (0.1 * rng.randn(b)).astype(np.float32))
             for a, b in zip(layers[:-1], layers[1:])]
    X = (lb + (ub - lb) * rng.rand(n, 2)).astype(np.float32)
    return pairs, X


def _jax(pairs):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in pairs]


@pytest.mark.parametrize("layers,n,nu", [
    ([2, 20, 20, 20, 1], 700, 0.01 / np.pi),   # ragged, tests/test_pallas.py
    ([2, 20, 1], 2048, 0.01),                  # exactly one 2,048-point tile
    (FLAGSHIP, 700, 0.01 / np.pi),             # flagship depth
])
@pytest.mark.parametrize("layout", ["burgers_residual", "burgers_residual_fmajor"])
def test_burgers_residual_matches_jax(layers, n, nu, layout):
    pairs, X = _case(layers, n, LB, UB, seed=n + len(layers))
    want = np.asarray(getattr(pallas_residual, layout)(
        _jax(pairs), jnp.asarray(X), LB, UB, nu, interpret=True))
    got = getattr(residual, layout)(params_from_numpy(pairs, "cpu"),
                                    torch.as_tensor(X), LB, UB, nu)
    assert tuple(got.shape) == want.shape == (n, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("layers,n", [([2, 32, 32, 2], 600),
                                      ([2, 100, 100, 100, 100, 2], 700)])
def test_schrodinger_residual_matches_jax(layers, n):
    pairs, X = _case(layers, n, S_LB, S_UB, seed=n)
    fu_want, fv_want = pallas_residual.schrodinger_residual(
        _jax(pairs), jnp.asarray(X), S_LB, S_UB, interpret=True)
    fu, fv = residual.schrodinger_residual(params_from_numpy(pairs, "cpu"),
                                           torch.as_tensor(X), S_LB, S_UB)
    np.testing.assert_allclose(fu.numpy(), np.asarray(fu_want), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(fv.numpy(), np.asarray(fv_want), rtol=2e-4,
                               atol=2e-6)


# The shapes the block-tiled residual kernels cut (pt_narrow.cuh: a
# block a 32-point tile, hidden width <= 64): one point, a tile less or
# more one point, hidden widths that are not multiples of 4, the widest
# pack and the most hidden layers the Burgers entries take.  Each in the
# unit box and in Schrödinger's, (-5, 0) to (5, pi/2), whose tangent
# scales are neither 1 nor 2; the ids name the box where it is not the
# unit one.
TILE_EDGES = [(FLAGSHIP, 1), (FLAGSHIP, 31), (FLAGSHIP, 33),
              ([2, 7, 33, 64, 1], 100), ([2] + [64] * 14 + [1], 40)]


@pytest.mark.parametrize("layers,n,box", [
    pytest.param(layers, n, box, id=f"{tag}layers{i}-{n}")
    for box, tag in (("unit", ""), ("schrodinger", "schrodinger_box-"))
    for i, (layers, n) in enumerate(TILE_EDGES)])
@pytest.mark.parametrize("layout", ["burgers_residual", "burgers_residual_fmajor"])
def test_burgers_residual_tile_edges_match_jax(layers, n, box, layout):
    lb, ub = (LB, UB) if box == "unit" else (S_LB, S_UB)
    pairs, X = _case(layers, n, lb, ub, seed=10 * n + len(layers))
    want = np.asarray(getattr(pallas_residual, layout)(
        _jax(pairs), jnp.asarray(X), lb, ub, 0.01 / np.pi, interpret=True))
    got = getattr(residual, layout)(params_from_numpy(pairs, "cpu"),
                                    torch.as_tensor(X), lb, ub, 0.01 / np.pi)
    assert tuple(got.shape) == want.shape == (n, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6)


# The shapes the tiled Schrödinger kernel cuts (pt_tile.cuh: 32-point
# tiles, hidden widths padded to 4): one point, a tile and one point,
# widths that are not multiples of 4, one hidden layer, the widest net.
@pytest.mark.parametrize("layers,n", [
    ([2, 100, 100, 100, 100, 2], 1), ([2, 100, 100, 100, 100, 2], 33),
    ([2, 30, 30, 2], 100), ([2, 100, 2], 50), ([2, 128, 128, 2], 70),
])
def test_schrodinger_residual_tile_edges_match_jax(layers, n):
    pairs, X = _case(layers, n, S_LB, S_UB, seed=10 * n + len(layers))
    fu_want, fv_want = pallas_residual.schrodinger_residual(
        _jax(pairs), jnp.asarray(X), S_LB, S_UB, interpret=True)
    fu, fv = residual.schrodinger_residual(params_from_numpy(pairs, "cpu"),
                                           torch.as_tensor(X), S_LB, S_UB)
    assert tuple(fu.shape) == tuple(fv.shape) == (n, 1)
    np.testing.assert_allclose(fu.numpy(), np.asarray(fu_want), rtol=2e-4,
                               atol=2e-6)
    np.testing.assert_allclose(fv.numpy(), np.asarray(fv_want), rtol=2e-4,
                               atol=2e-6)


def test_plain_versions_are_the_eager_residuals_in_float64():
    """The kernels' arithmetic, run in float64 (the plain versions
    called directly: the wrappers take float32 only), is the eager
    Taylor-stream residual of pinn_torch.problems."""
    pairs, X = _case([2, 12, 12, 1], 50, LB, UB, seed=1)
    params = params_from_numpy(pairs, "cpu", torch.float64)
    Xt = torch.as_tensor(X, dtype=torch.float64)
    lb, ub = (torch.as_tensor(a, dtype=torch.float64) for a in (LB, UB))
    want = burgers.residual_cont(params, Xt, lb, ub, nu=0.003)
    for plain in (residual.burgers_residual_plain,
                  residual.burgers_residual_fmajor_plain):
        torch.testing.assert_close(plain(params, Xt, lb, ub, 0.003), want,
                                   rtol=1e-12, atol=1e-14)
    spairs, SX = _case([2, 16, 16, 2], 50, S_LB, S_UB, seed=2)
    sparams = params_from_numpy(spairs, "cpu", torch.float64)
    SXt = torch.as_tensor(SX, dtype=torch.float64)
    slb, sub = (torch.as_tensor(a, dtype=torch.float64) for a in (S_LB, S_UB))
    for g, w in zip(residual.schrodinger_residual_plain(sparams, SXt, slb, sub),
                    schrodinger.residual(sparams, SXt, slb, sub)):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-14)


def test_wrappers_take_float32_only_and_check_shapes():
    pairs, X = _case([2, 8, 1], 10, LB, UB, seed=3)
    p32 = params_from_numpy(pairs, "cpu")
    with pytest.raises(TypeError, match="float32"):
        residual.burgers_residual(params_from_numpy(pairs, "cpu", torch.float64),
                                  torch.as_tensor(X, dtype=torch.float64),
                                  LB, UB, 0.01)
    with pytest.raises(ValueError, match="N, 2"):
        residual.burgers_residual_fmajor(p32, torch.zeros(3, 3), LB, UB, 0.01)
    with pytest.raises(ValueError, match="2 output"):
        residual.schrodinger_residual(p32, torch.as_tensor(X), LB, UB)
    before = trace.counters()
    residual.burgers_residual(p32, torch.as_tensor(X), LB, UB, 0.01)
    # the plain version counts no launch
    assert not [k for k in trace.delta(before, trace.counters())
                if k.startswith("launch.")]
