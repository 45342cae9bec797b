"""Korteweg–de Vries, discrete time (q-stage IRK): identification.

Counterpart of ``pinn/problems/kdv.py``:

    u_t + lambda1 u u_x + lambda2 u_xxx = 0,   x in [-1, 1), periodic,

with trainable lambda1 and lambda2 = exp(log_lambda2) (``IdeParams``,
inits 0 and -6) recovered from two snapshots bridged by one IRK step.
The structure is Burgers' discrete identification with the third
x-derivative, from the order-3 stream of the same Taylor pass, in
place of diffusion.  Losses are sums of squares.
"""

from __future__ import annotations

import torch

from pinn_torch.models import mlp
from pinn_torch.problems.burgers import IdeParams, init_ide_params, sse  # noqa: F401

LAMBDA1_STAR = 1.0
LAMBDA2_STAR = 0.0025


def _stage_derivs3(net_params, x, lb, ub):
    """(U, U_x, U_xxx) stage matrices in one order-3 Taylor pass."""
    v1 = torch.ones((1,), dtype=x.dtype, device=x.device)
    out = mlp.taylor_apply(net_params, x, lb, ub, v1, order=3)
    return out.value, out.d1, out.d111


def disc_ide_stage_maps(params: IdeParams, x, lb, ub, dt, irk_alpha,
                        irk_beta):
    """(U_0, U_1) with N = lambda1 U U_x + exp(log_lambda2) U_xxx
    (u_t = -N): U_0 = U + dt N alpha^T, U_1 = U + dt (-N)(beta - alpha)^T."""
    U, U_x, U_xxx = _stage_derivs3(params.net, x, lb, ub)
    l1 = params.lambda1
    l2 = torch.exp(params.log_lambda2)
    N = l1 * U * U_x + l2 * U_xxx
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


def lambda_error(params: IdeParams) -> float:
    """Mean relative error of the recovered coefficients."""
    l1 = float(params.lambda1[0])
    l2 = float(torch.exp(params.log_lambda2[0]))
    return 0.5 * (abs(l1 - LAMBDA1_STAR) / LAMBDA1_STAR
                  + abs(l2 - LAMBDA2_STAR) / LAMBDA2_STAR)
