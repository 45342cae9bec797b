"""The port's fused Burgers loss (pinn_torch.ops.fused_train) against the
JAX package's fused loss (pinn.ops.pallas_train, interpret mode).

On the CPU the port's wrapper takes the kernel's plain PyTorch version
through the same host-side prep and reassembly as the CUDA kernel, so
these tests check everything but the kernel body.  Bars are those of
tests/test_pallas_train.py: loss rtol 1e-5, gradients rtol 5e-4 with
atol 5e-6 * max|g| (float32 summed in another order on each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.ops import pallas_train
from pinn_torch.ops import fused_train
from pinn_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(1)

NU = 0.01 / np.pi
LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)


def _glorot(layers, rng):
    return [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), np.zeros(b))
            for a, b in zip(layers[:-1], layers[1:])]


def _case(layers, n_u, n_f, seed=0):
    rng = np.random.RandomState(seed)
    pairs = [(w.astype(np.float32), (0.1 * rng.randn(*b.shape)).astype(np.float32))
             for w, b in _glorot(layers, rng)]
    batch = {"X_u": LB + (UB - LB) * rng.rand(n_u, 2),
             "u": rng.rand(n_u, 1),
             "X_f": LB + (UB - LB) * rng.rand(n_f, 2)}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    return pairs, batch


def _jax_value_and_grad(pairs, batch):
    loss = pallas_train.make_burgers_loss(LB, UB, NU, interpret=True)
    params = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    val, grads = jax.value_and_grad(loss)(params, jb)
    return float(val), [np.asarray(a) for wb in grads for a in wb]


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


CASES = [
    ([2, 20, 20, 20, 1], 32, 300),   # ragged edge
    ([2, 16, 1], 7, 1017),           # one hidden layer, data+collocation straddle a tile
    ([2, 40, 40, 1], 16, 256),       # width 40
]


@pytest.mark.parametrize("layers,n_u,n_f", CASES)
def test_fused_loss_and_grad_match_jax(layers, n_u, n_f):
    pairs, batch = _case(layers, n_u, n_f)
    want_val, want_grads = _jax_value_and_grad(pairs, batch)

    params = params_from_numpy(pairs, "cpu", torch.float32)
    for w, b in params:
        w.requires_grad_(True)
        b.requires_grad_(True)
    loss = fused_train.make_burgers_loss(LB, UB, NU)
    val = loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(val, [a for wb in params for a in wb])

    np.testing.assert_allclose(float(val.detach()), want_val, rtol=1e-5)
    for g, want in zip(grads, want_grads):
        scale = max(1e-3, float(np.max(np.abs(want))))
        np.testing.assert_allclose(g.numpy(), want, rtol=5e-4,
                                   atol=5e-6 * scale)


@pytest.mark.parametrize("layers,n_u,n_f", CASES)
def test_loss_only_branch_matches(layers, n_u, n_f):
    """Under no_grad the wrapper takes the loss-only path; its value
    equals the loss+grad path's and the JAX primal's."""
    pairs, batch = _case(layers, n_u, n_f, seed=1)
    params = params_from_numpy(pairs, "cpu", torch.float32)
    tb = _torch_batch(batch)
    loss = fused_train.make_burgers_loss(LB, UB, NU)
    with torch.no_grad():
        v_nograd = float(loss(params, tb))
    grad_params = [(w.clone().requires_grad_(True), b.clone().requires_grad_(True))
                   for w, b in params]
    v_grad = float(loss(grad_params, tb).detach())
    np.testing.assert_allclose(v_nograd, v_grad, rtol=1e-6)

    jloss = pallas_train.make_burgers_loss(LB, UB, NU, interpret=True)
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    want = float(jloss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    np.testing.assert_allclose(v_nograd, want, rtol=1e-5)


def test_backward_scales_by_grad_output():
    """backward is the stashed gradient times grad_output."""
    pairs, batch = _case([2, 8, 8, 1], 5, 40, seed=2)
    params = params_from_numpy(pairs, "cpu", torch.float32)
    for w, b in params:
        w.requires_grad_(True)
        b.requires_grad_(True)
    leaves = [a for wb in params for a in wb]
    loss = fused_train.make_burgers_loss(LB, UB, NU)
    tb = _torch_batch(batch)
    g1 = torch.autograd.grad(loss(params, tb), leaves)
    g3 = torch.autograd.grad(3.0 * loss(params, tb), leaves)
    for a, b in zip(g1, g3):
        torch.testing.assert_close(3.0 * a, b, rtol=1e-6, atol=0.0)


def test_plain_version_matches_eager_loss_in_float64():
    """The kernel's plain version, run through prep and reassembly in
    float64, is the eager loss_cont_inference and its autograd."""
    from pinn_torch.problems import burgers

    pairs, batch = _case([2, 12, 12, 1], 9, 70, seed=3)
    params = params_from_numpy(pairs, "cpu", torch.float64)
    tb = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in batch.items()}
    lb, ub = (torch.as_tensor(a, dtype=torch.float64) for a in (LB, UB))
    a0, aux = fused_train._prep_points(tb, lb, ub)
    scale = 2.0 / (ub - lb)
    vx = torch.stack([scale[0], torch.zeros((), dtype=torch.float64)])
    vt = torch.stack([torch.zeros((), dtype=torch.float64), scale[1]])
    z1row, z2row, wt_args = fused_train._prep(params, vx, vt)
    val, gwt, gz1, gz2 = fused_train.burgers_loss_grad_plain(
        a0, aux, z1row, z2row, wt_args, NU)
    grads = fused_train._assemble_net_grads(params, gwt, gz1, gz2, vx, vt)

    leaves = [a.clone().requires_grad_(True) for wb in params for a in wb]
    pp = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    want = burgers.loss_cont_inference(pp, tb["X_u"], tb["u"], tb["X_f"],
                                       lb, ub, NU)
    want_grads = torch.autograd.grad(want, leaves)
    torch.testing.assert_close(val, want.detach(), rtol=1e-12, atol=0.0)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-14)


def test_kernel_input_checks():
    """The checks the CUDA launch runs before it touches the card."""
    pairs, batch = _case([2, 8, 1], 3, 10, seed=4)
    params = params_from_numpy(pairs, "cpu", torch.float32)
    lb, ub = torch.as_tensor(LB), torch.as_tensor(UB)
    a0, aux = fused_train._prep_points(_torch_batch(batch), lb, ub)
    vx = torch.tensor([1.0, 0.0])
    vt = torch.tensor([0.0, 2.0])
    z1row, z2row, wt_args = fused_train._prep(params, vx, vt)
    fused_train._check_inputs(a0, aux, z1row, z2row, wt_args)
    with pytest.raises(TypeError, match="float32"):
        fused_train._check_inputs(a0.double(), aux, z1row, z2row, wt_args)
    with pytest.raises(ValueError, match="aux"):
        fused_train._check_inputs(a0, aux[:, 1:], z1row, z2row, wt_args)
    with pytest.raises(ValueError, match="contiguous"):
        fused_train._check_inputs(a0.t().contiguous().t(), aux, z1row,
                                  z2row, wt_args)
    with pytest.raises(NotImplementedError, match="bf16"):
        fused_train.make_burgers_loss(LB, UB, NU, stream_dtype="bfloat16")
