"""Allen–Cahn, discrete time (q-stage IRK): stage map and loss.

Counterpart of ``pinn/problems/allencahn.py``:

    u_t - 0.0001 u_xx + 5 u^3 - 5 u = 0,   x in [-1, 1), periodic,

solved as one IRK step from the t0 snapshot to t1.  The nonlinearity
F = 5 (U^3 - U) - 0.0001 U_xx takes the place of Burgers' advection,
and the boundary terms are periodic: every stage value and its
x-derivative must agree between x = lb and x = ub.  Losses are sums of
squares.
"""

from __future__ import annotations

import torch

from pinn_torch.models import mlp
from pinn_torch.problems.burgers import _stage_derivs, sse

DIFF = 1e-4   # diffusion coefficient
REACT = 5.0   # reaction coefficient


def u0_pred_disc_inference(net_params, x_0, lb, ub, dt, irk_weights,
                           diff=DIFF, react=REACT):
    """Backward IRK map from the q + 1 outputs U1(x) to u at t0:
    U_0 = U_1 + dt F W^T, F = react (U^3 - U) - diff U_xx over the q
    stage columns, W the (q+1, q) stacked [A; b]."""
    U1, _, U1_xx = _stage_derivs(net_params, x_0, lb, ub)
    U, U_xx = U1[:, :-1], U1_xx[:, :-1]
    F = react * (U ** 3 - U) - diff * U_xx
    return U1 + dt * F @ irk_weights.T


def periodic_bc_terms(net_params, x_bnd, lb, ub):
    """(U(lb) - U(ub), U_x(lb) - U_x(ub)), each (q+1,), from the (2, 1)
    stack ``x_bnd`` = [lb; ub]."""
    Ub, Ub_x, _ = _stage_derivs(net_params, x_bnd, lb, ub)
    return Ub[0] - Ub[1], Ub_x[0] - Ub_x[1]


def loss_disc_inference(net_params, x_0, u_0, x_bnd, lb, ub, dt,
                        irk_weights, diff=DIFF, react=REACT) -> torch.Tensor:
    """SSE to the t0 snapshot + SSE of the periodic value gap + SSE of
    the periodic derivative gap."""
    u_0_pred = u0_pred_disc_inference(net_params, x_0, lb, ub, dt,
                                      irk_weights, diff, react)
    gap_u, gap_ux = periodic_bc_terms(net_params, x_bnd, lb, ub)
    return sse(u_0_pred - u_0) + sse(gap_u) + sse(gap_ux)


def predict_u1(net_params, x, lb, ub) -> torch.Tensor:
    """u(t1, x): the network's last output column."""
    return mlp.apply(net_params, x, lb, ub)[:, -1]
