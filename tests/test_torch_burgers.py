"""The port's eager continuous Burgers terms (residual_cont,
loss_cont_inference with and without f_weights) against the JAX
package's value and jax.value_and_grad, in float64, to rtol 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.models import mlp as jax_mlp
from pinn.problems import burgers as jax_burgers
from pinn_torch.problems import burgers
from pinn_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(1)

NU = 0.01 / np.pi
LB = np.array([-1.0, 0.0])
UB = np.array([1.0, 1.0])
LAYERS = [2, 20, 20, 20, 1]


def _case(seed, n_u=40, n_f=300):
    jp = jax_mlp.init_mlp(jax.random.PRNGKey(seed), LAYERS, jnp.float64)
    rng = np.random.RandomState(seed)
    X_u = LB + (UB - LB) * rng.rand(n_u, 2)
    u = rng.randn(n_u, 1)
    X_f = LB + (UB - LB) * rng.rand(n_f, 2)
    w = np.where(rng.rand(n_f) < 0.8, 1.0 / n_f, 0.0)
    return jp, X_u, u, X_f, w


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def test_residual_matches_jax():
    jp, _, _, X_f, _ = _case(0)
    want = np.asarray(jax_burgers.residual_cont(jp, jnp.asarray(X_f), LB, UB,
                                                nu=NU))
    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp],
                           "cpu", torch.float64)
    got = burgers.residual_cont(tp, _t(X_f), _t(LB), _t(UB), nu=NU).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_and_grad_match_jax(weighted):
    jp, X_u, u, X_f, w = _case(1 + weighted)
    fw = w if weighted else None

    def jloss(p):
        return jax_burgers.loss_cont_inference(
            p, jnp.asarray(X_u), jnp.asarray(u), jnp.asarray(X_f), LB, UB, NU,
            f_weights=None if fw is None else jnp.asarray(fw))

    want, want_g = jax.value_and_grad(jloss)(jp)
    leaves = [_t(np.asarray(a)).requires_grad_(True)
              for a in jax.tree_util.tree_leaves(jp)]
    tp = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    got = burgers.loss_cont_inference(tp, _t(X_u), _t(u), _t(X_f), _t(LB),
                                      _t(UB), NU,
                                      f_weights=None if fw is None else _t(fw))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    for g, wg in zip(grads, jax.tree_util.tree_leaves(want_g)):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg, rtol=1e-10,
                                   atol=1e-12 * np.abs(wg).max())
