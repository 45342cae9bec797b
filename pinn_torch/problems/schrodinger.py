"""1D nonlinear Schrödinger: residual and loss (continuous inference).

Counterpart of ``pinn/problems/schrodinger.py``.  The complex field
h = u + iv is a 2-output real network; the PDE i h_t + 0.5 h_xx +
|h|^2 h = 0 splits into

    f_u = u_t + 0.5 v_xx + (u^2 + v^2) v
    f_v = v_t - 0.5 u_xx - (u^2 + v^2) u

and the loss is MSE(initial data) + MSE(periodic BCs on value and
x-derivative) + MSE(residual).  This eager loss is the float64 engine
of the port and the oracle of the fused kernel's plain version
(``pinn_torch.ops.fused_schrodinger``), which replaces only the
residual term.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pinn_torch.models import mlp


def _vx(X: torch.Tensor) -> torch.Tensor:
    return torch.tensor([1.0, 0.0], dtype=X.dtype, device=X.device)


def _vt(X: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 1.0], dtype=X.dtype, device=X.device)


def mse(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(x))


def residual(net_params, X_f, lb, ub):
    """(f_u, f_v), each (N, 1), at the collocation points."""
    out = mlp.taylor_apply(net_params, X_f, lb, ub, _vx(X_f), _vt(X_f))
    u, v = out.value[:, 0:1], out.value[:, 1:2]
    u_xx, v_xx = out.d11[:, 0:1], out.d11[:, 1:2]
    u_t, v_t = out.d2[:, 0:1], out.d2[:, 1:2]
    h2 = u * u + v * v
    f_u = u_t + 0.5 * v_xx + h2 * v
    f_v = v_t - 0.5 * u_xx - h2 * u
    return f_u, f_v


class SchrodingerLossTerms(NamedTuple):
    mse_0: torch.Tensor
    mse_b: torch.Tensor
    mse_f: torch.Tensor

    @property
    def total(self) -> torch.Tensor:
        return self.mse_0 + self.mse_b + self.mse_f


def ic_bc_terms(net_params, X0, H0, X_lb, X_ub, lb, ub):
    """(mse_0, mse_b): the initial-condition and periodic-boundary
    terms, shared by the eager loss and the fused one."""
    # Per-column means, as the reference sums mean(u err) + mean(v err).
    H0_pred = mlp.apply(net_params, X0, lb, ub)
    mse_0 = mse(H0[:, 0] - H0_pred[:, 0]) + mse(H0[:, 1] - H0_pred[:, 1])

    # Periodic BCs: match value and x-derivative across the boundary.
    out_lo = mlp.taylor_apply(net_params, X_lb, lb, ub, _vx(X_lb), order=1)
    out_hi = mlp.taylor_apply(net_params, X_ub, lb, ub, _vx(X_ub), order=1)
    mse_b = (mse(out_lo.value[:, 0] - out_hi.value[:, 0])
             + mse(out_lo.value[:, 1] - out_hi.value[:, 1])
             + mse(out_lo.d1[:, 0] - out_hi.d1[:, 0])
             + mse(out_lo.d1[:, 1] - out_hi.d1[:, 1]))
    return mse_0, mse_b


def loss_terms(net_params, X0, H0, X_lb, X_ub, X_f, lb, ub,
               f_weights: Optional[torch.Tensor] = None) -> SchrodingerLossTerms:
    """The three loss terms.  X0: (N_0, 2) points (x0, 0); H0: (N_0, 2)
    their (u, v); X_lb/X_ub: (N_b, 2) boundary points at x = lb/ub."""
    mse_0, mse_b = ic_bc_terms(net_params, X0, H0, X_lb, X_ub, lb, ub)
    f_u, f_v = residual(net_params, X_f, lb, ub)
    if f_weights is None:
        mse_f = mse(f_u) + mse(f_v)
    else:
        mse_f = (torch.sum(torch.square(f_u[:, 0]) * f_weights)
                 + torch.sum(torch.square(f_v[:, 0]) * f_weights))
    return SchrodingerLossTerms(mse_0, mse_b, mse_f)


def loss(net_params, X0, H0, X_lb, X_ub, X_f, lb, ub,
         f_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return loss_terms(net_params, X0, H0, X_lb, X_ub, X_f, lb, ub,
                      f_weights).total
