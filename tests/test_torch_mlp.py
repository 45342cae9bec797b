"""The port's MLP (apply, taylor_apply at order 2 and 3) against the JAX
package's, in float64 on the same weights (carried across with
params_from_numpy), to rtol 1e-12; and the flat codec and npz
checkpoints, byte for byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn import params as jax_params
from pinn.models import mlp as jax_mlp
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec
from pinn_torch.models import mlp
from pinn_torch.utils import checkpoint
from pinn_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(1)

LAYERS = [2, 20, 20, 20, 1]
LB = np.array([-1.0, 0.0])
UB = np.array([1.0, 1.0])


def _setup(seed=0, n=257):
    jp = jax_mlp.init_mlp(jax.random.PRNGKey(seed), LAYERS, jnp.float64)
    pairs = [(np.asarray(w), np.asarray(b)) for w, b in jp]
    rng = np.random.RandomState(seed)
    X = LB + (UB - LB) * rng.rand(n, 2)
    return jp, params_from_numpy(pairs, "cpu", torch.float64), X


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def test_apply_matches_jax():
    jp, tp, X = _setup()
    want = np.asarray(jax_mlp.apply(jp, jnp.asarray(X), LB, UB))
    got = mlp.apply(tp, _t(X), _t(LB), _t(UB)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("order", [2, 3])
def test_taylor_apply_matches_jax(order):
    jp, tp, X = _setup(seed=1)
    v1, v2 = np.array([1.0, 0.0]), np.array([0.0, 1.0])
    want = jax_mlp.taylor_apply(jp, jnp.asarray(X), LB, UB, jnp.asarray(v1),
                                jnp.asarray(v2), order=order)
    got = mlp.taylor_apply(tp, _t(X), _t(LB), _t(UB), _t(v1), _t(v2),
                           order=order)
    for name in ("value", "d1", "d11", "d2", "d111"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-13, err_msg=name)


@pytest.mark.parametrize("order", [2, 3])
def test_taylor_apply_din1_matches_jax(order):
    """din = 1, the discrete-time families' stage pass: one direction,
    v1 = [1], no v2, many outputs (the IRK stages)."""
    layers, lb, ub = [1, 20, 20, 33], np.array([-1.0]), np.array([1.0])
    jp = jax_mlp.init_mlp(jax.random.PRNGKey(3), layers, jnp.float64)
    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp],
                           "cpu", torch.float64)
    X = lb + (ub - lb) * np.random.RandomState(3).rand(40, 1)
    v1 = np.array([1.0])
    want = jax_mlp.taylor_apply(jp, jnp.asarray(X), lb, ub, jnp.asarray(v1),
                                order=order)
    got = mlp.taylor_apply(tp, _t(X), _t(lb), _t(ub), _t(v1), order=order)
    for name in ("value", "d1", "d11", "d2", "d111"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        assert g.shape == (40, 33), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-13, err_msg=name)


def test_single_linear_layer_matches_jax():
    jp = jax_mlp.init_mlp(jax.random.PRNGKey(2), [2, 3], jnp.float64)
    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp],
                           "cpu", torch.float64)
    X = np.random.RandomState(2).rand(9, 2)
    v1 = np.array([1.0, 0.0])
    want = jax_mlp.taylor_apply(jp, jnp.asarray(X), LB, UB, jnp.asarray(v1))
    got = mlp.taylor_apply(tp, _t(X), _t(LB), _t(UB), _t(v1))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-12)
    np.testing.assert_allclose(got.d1.numpy(), np.asarray(want.d1), rtol=1e-12)
    assert not got.d11.any() and got.d2 is None


def test_init_mlp_glorot_statistics():
    """torch cannot draw JAX's threefry bits; the init is checked by its
    law: truncated at 2 sigma, glorot std, zero biases, seeded."""
    gen = torch.Generator().manual_seed(0)
    params = mlp.init_mlp([2, 200, 300, 1], gen, torch.float64, "cpu")
    w = params[1][0]
    std = (2.0 / 500) ** 0.5
    assert w.shape == (200, 300)
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-12
    assert all(not b.any() for _, b in params)
    again = mlp.init_mlp([2, 200, 300, 1], torch.Generator().manual_seed(0),
                         torch.float64, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pcodec.leaves(params),
                                                 pcodec.leaves(again)))


def test_mlp_module_predicts_with_apply():
    gen = torch.Generator().manual_seed(3)
    net = mlp.MLP([2, 8, 8, 1], LB, UB, gen, torch.float64, "cpu")
    X = _t(np.random.RandomState(3).rand(5, 2))
    torch.testing.assert_close(net(X), mlp.apply(net.params(), X, net.lb, net.ub))
    assert len(list(net.parameters())) == 6


def test_flat_codec_and_npz_match_jax(tmp_path):
    jp, tp, _ = _setup(seed=4)
    np.testing.assert_array_equal(pcodec.ravel(tp).numpy(),
                                  np.asarray(jax_params.ravel(jp)))
    back = pcodec.make_unravel(tp)(pcodec.ravel(tp))
    assert all(torch.equal(a, b) for a, b in zip(pcodec.leaves(back),
                                                 pcodec.leaves(tp)))
    assert pcodec.num_params(tp) == jax_params.num_params(jp)

    # a file written by either package loads in the other
    jax_path, torch_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jax_checkpoint.save_npz(jax_path, jp)
    checkpoint.save_npz_atomic(torch_path, tp)
    loaded, _ = checkpoint.load_npz(jax_path, like=tp)
    assert all(torch.equal(a, b) for a, b in zip(pcodec.leaves(loaded),
                                                 pcodec.leaves(tp)))
    jloaded, _ = jax_checkpoint.load_npz(torch_path, like=jp)
    for a, b in zip(jax.tree_util.tree_leaves(jloaded),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
