"""1D viscous Burgers: continuous-time residual, inference and
identification losses.

Counterpart of the continuous terms of ``pinn/problems/burgers.py``:
``f = u_t + lambda1 u u_x - lambda2 u_xx`` from one Taylor-mode pass,
``loss = mse(u - u_pred) + mse(f)`` for inference, and for
identification the same with trainable ``lambda1`` and
``lambda2 = exp(log_lambda2)`` (``IdeParams``), the residual taken at
the data points.  These eager losses are the float64 engine of the
port (the refinement stage) and the oracles the fused kernels' plain
versions are tested against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pinn_torch.models import mlp


def mse(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(x))


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
