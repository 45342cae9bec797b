"""Continuous-time Burgers inference, Raissi et al. (arXiv:1711.10561)
section 3.1.  u solves u_t + u u_x - nu u_xx = 0 on x in [-1, 1]:

    f = u_t + u u_x - nu u_xx,
    loss = mse_u + mse_f,

mse_u the mean squared misfit of u against the data at the N_u initial
and boundary points, mse_f = mean f^2 over the N_f collocation points.

Departures from the published description: the net's input is
normalised to [-1, 1] over the box [lb, ub] (as the published code
does, not the paper's text); the collocation sum is taken in blocks of
``BLOCK`` points, each block's share added to the loss in turn, so that
the reference fits the card at N_f = 1,000,000.

``inputs``: ``X_u`` (N_u, 2), ``u`` (N_u, 1), ``X_f`` (N_f, 2);
``const``: ``lb``, ``ub``, ``nu``.  Products run in the precision's
``mm``: the harness turns TF32 off (``precision.ieee_matmuls``), and
the control rounds to TF32 explicitly.
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
    nu = float(const["nu"])
    X_u, u, X_f = (inputs[k].to(dt) for k in ("X_u", "u", "X_f"))
    n_f = X_f.shape[0]

    def terms(params):
        r = value(params, X_u, lb, ub, prec.mm) - u
        yield torch.mean(r * r)
        for i in range(0, n_f, block):
            s = streams(params, X_f[i:i + block], lb, ub, prec.mm)
            f = s.u_t + s.u * s.u_x - nu * s.u_xx
            yield torch.sum(f * f) / n_f

    return sum_terms([a.to(dt) for a in leaves], terms, grads)
