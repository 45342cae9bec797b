"""Continuous-time nonlinear Schrödinger inference, Raissi et al.
(2019) section 3.1.1.  h = u + i v solves i h_t + 0.5 h_xx + |h|^2 h = 0
with periodic boundaries:

    f_u = u_t + 0.5 v_xx + (u^2 + v^2) v,
    f_v = v_t - 0.5 u_xx - (u^2 + v^2) u,
    loss = mse_0 + mse_b + mse_f,

mse_0 the mean squared misfit of (u, v) against the initial data (each
component's mean), mse_b that of the values and x-derivatives of u and
v between x = lb and x = ub at the boundary times, mse_f = mean f_u^2 +
mean f_v^2 over the collocation points.

``inputs``: ``X0`` (N_0, 2) the points (x0, 0), ``H0`` (N_0, 2) their
(u, v), ``X_lb``/``X_ub`` (N_b, 2) the boundary points, ``X_f``
(N_f, 2); ``const``: ``lb``, ``ub``.
"""

from __future__ import annotations

import torch

from portbench.reference.mlp import streams, sum_terms, value

BLOCK = 1 << 17


def loss_and_grad(leaves, inputs, const, prec, grads: bool = True,
                  block: int = BLOCK):
    """``(loss, [grad of each leaf] or None)`` in ``prec``."""
    dt = prec.dtype
    dev = leaves[0].device
    lb = torch.as_tensor(const["lb"], device=dev).to(dt)
    ub = torch.as_tensor(const["ub"], device=dev).to(dt)
    X0, H0, X_lb, X_ub, X_f = (inputs[k].to(dt) for k in
                               ("X0", "H0", "X_lb", "X_ub", "X_f"))
    n_f = X_f.shape[0]

    def mse(x):
        return torch.mean(x * x)

    def terms(params):
        H = value(params, X0, lb, ub, prec.mm)
        yield mse(H[:, 0] - H0[:, 0]) + mse(H[:, 1] - H0[:, 1])
        lo = streams(params, X_lb, lb, ub, prec.mm)
        hi = streams(params, X_ub, lb, ub, prec.mm)
        yield (mse(lo.u[:, 0] - hi.u[:, 0]) + mse(lo.u[:, 1] - hi.u[:, 1])
               + mse(lo.u_x[:, 0] - hi.u_x[:, 0])
               + mse(lo.u_x[:, 1] - hi.u_x[:, 1]))
        for i in range(0, n_f, block):
            s = streams(params, X_f[i:i + block], lb, ub, prec.mm)
            u, v = s.u[:, 0:1], s.u[:, 1:2]
            h2 = u * u + v * v
            f_u = s.u_t[:, 0:1] + 0.5 * s.u_xx[:, 1:2] + h2 * v
            f_v = s.u_t[:, 1:2] - 0.5 * s.u_xx[:, 0:1] - h2 * u
            yield (torch.sum(f_u * f_u) + torch.sum(f_v * f_v)) / n_f

    return sum_terms([a.to(dt) for a in leaves], terms, grads)
