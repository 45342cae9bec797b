"""1D viscous Burgers: residuals and losses of all four modes.

Counterpart of ``pinn/problems/burgers.py``.

Continuous time: ``f = u_t + lambda1 u u_x - lambda2 u_xx`` from one
Taylor-mode pass, ``loss = mse(u - u_pred) + mse(f)`` for inference,
and for identification the same with trainable ``lambda1`` and
``lambda2 = exp(log_lambda2)`` (``IdeParams``), the residual taken at
the data points.  These eager losses are the float64 engine of the
port (the refinement stage) and the oracles the fused kernels' plain
versions are tested against.

Discrete time (q-stage IRK): the network maps x to the stage values;
their x-derivatives come from one Taylor pass along x (the input is
1-D, so the tangent is one constant row), and a (N, q)·(q, q+1)
product couples the stages.  The losses are sums of squares, not
means, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pinn_torch.models import mlp


def mse(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(x))


def sse(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x))


def _vx(X: torch.Tensor) -> torch.Tensor:
    return torch.tensor([1.0, 0.0], dtype=X.dtype, device=X.device)


def _vt(X: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 1.0], dtype=X.dtype, device=X.device)


def residual_cont(net_params, X_f, lb, ub, lambda1=1.0, lambda2=None,
                  nu=None) -> torch.Tensor:
    """f = u_t + lambda1 u u_x - lambda2 u_xx at the points ``X_f``
    (inference: pass ``nu``)."""
    if lambda2 is None:
        lambda2 = nu
    out = mlp.taylor_apply(net_params, X_f, lb, ub, _vx(X_f), _vt(X_f))
    return out.d2 + lambda1 * out.value * out.d1 - lambda2 * out.d11


def loss_cont_inference(net_params, X_u, u, X_f, lb, ub, nu,
                        f_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE(data) + MSE(residual).  ``f_weights`` (N_f,) replaces the
    residual mean by a weighted sum (1/N_real on real points, 0 on
    padding)."""
    u_pred = mlp.apply(net_params, X_u, lb, ub)
    f = residual_cont(net_params, X_f, lb, ub, nu=nu)
    if f_weights is None:
        mse_f = mse(f)
    else:
        mse_f = torch.sum(torch.square(f[:, 0]) * f_weights)
    return mse(u - u_pred) + mse_f


class IdeParams(NamedTuple):
    """Identification-mode trainables: the net's ``(W, b)`` pairs and
    the PDE coefficients, each of shape (1,).  The coefficients sit at
    the tail of the flat vector, as in the JAX package."""

    net: list
    lambda1: torch.Tensor
    log_lambda2: torch.Tensor


def init_ide_params(net_params, dtype: Optional[torch.dtype] = None) -> IdeParams:
    """lambda1 = 0 and log lambda2 = -6, the reference's inits."""
    w0 = net_params[0][0]
    dtype = dtype or w0.dtype
    return IdeParams(net=net_params,
                     lambda1=torch.zeros((1,), dtype=dtype, device=w0.device),
                     log_lambda2=torch.full((1,), -6.0, dtype=dtype,
                                            device=w0.device))


def loss_cont_identification(params: IdeParams, X_u, u, lb, ub) -> torch.Tensor:
    """Data MSE + residual MSE at the data points (there is no separate
    collocation set)."""
    u_pred = mlp.apply(params.net, X_u, lb, ub)
    f = residual_cont(params.net, X_u, lb, ub, lambda1=params.lambda1,
                      lambda2=torch.exp(params.log_lambda2))
    return mse(u - u_pred) + mse(f)


# ---------------------------------------------------------------------------
# Discrete time (q-stage IRK)
# ---------------------------------------------------------------------------

def _stage_derivs(net_params, x, lb, ub):
    """(U, U_x, U_xx) stage matrices, each (N, dout), in one Taylor pass
    along x."""
    v1 = torch.ones((1,), dtype=x.dtype, device=x.device)
    out = mlp.taylor_apply(net_params, x, lb, ub, v1)
    return out.value, out.d1, out.d11


def u0_pred_disc_inference(net_params, x_0, lb, ub, nu, dt, irk_weights):
    """Backward IRK map from the q + 1 outputs U1(x) to u at t0:
    U_0 = U_1 + dt (U U_x - nu U_xx) W^T over the q stage columns, with
    W the (q+1, q) stacked [A; b]."""
    U1, U1_x, U1_xx = _stage_derivs(net_params, x_0, lb, ub)
    U, U_x, U_xx = U1[:, :-1], U1_x[:, :-1], U1_xx[:, :-1]
    N = U * U_x - nu * U_xx
    return U1 + dt * N @ irk_weights.T


def loss_disc_inference(net_params, x_0, u_0, x_1, lb, ub, nu, dt,
                        irk_weights) -> torch.Tensor:
    """SSE to the t0 snapshot + SSE of the homogeneous Dirichlet values
    at ``x_1`` = [lb; ub]."""
    u_0_pred = u0_pred_disc_inference(net_params, x_0, lb, ub, nu, dt,
                                      irk_weights)
    u_1_bnd = mlp.apply(net_params, x_1, lb, ub)
    return sse(u_0_pred - u_0) + sse(u_1_bnd)


def disc_ide_stage_maps(params: IdeParams, x, lb, ub, dt, irk_alpha,
                        irk_beta):
    """(U_0, U_1): the stage values mapped back to t0 and forward to t1,
    with N = lambda1 U U_x - exp(log_lambda2) U_xx."""
    U, U_x, U_xx = _stage_derivs(params.net, x, lb, ub)
    l1 = params.lambda1
    l2 = torch.exp(params.log_lambda2)
    N = l1 * U * U_x - l2 * U_xx
    U_0 = U + dt * N @ irk_alpha.T
    U_1 = U + dt * (-N) @ (irk_beta - irk_alpha).T
    return U_0, U_1


def loss_disc_identification(params: IdeParams, x_0, u_0, x_1, u_1, lb, ub,
                             dt, irk_alpha, irk_beta) -> torch.Tensor:
    """SSE to both snapshots."""
    U_0_pred, _ = disc_ide_stage_maps(params, x_0, lb, ub, dt, irk_alpha,
                                      irk_beta)
    _, U_1_pred = disc_ide_stage_maps(params, x_1, lb, ub, dt, irk_alpha,
                                      irk_beta)
    return sse(U_0_pred - u_0) + sse(U_1_pred - u_1)
