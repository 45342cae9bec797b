"""A new PDE on the port's facade: the 1D heat equation.

Counterpart of ``experiments/custom_pde_example.py``, with the same
``DEFAULT_HP``, draws and error:

    u_t = alpha u_xx  on [-1, 1] x [0, 1],  alpha = 0.1,
    u(x, 0) = sin(pi x),  u(+-1, t) = 0,
    exact u = exp(-alpha pi^2 t) sin(pi x).

``HeatPINN`` subclasses ``pinn_torch.api.PhysicsInformedNN`` through
its hooks: ``extra_batch`` hands the collocation points to the batch,
and ``loss`` builds the residual u_t - alpha u_xx from ``self.taylor``
(value, u_x, u_xx and u_t in one forward pass), which the Trainer
differentiates by autograd.  The net runs in the package's default
dtype (``pinn_torch.dtypes``), as the JAX example's does, on
``hp["device"]``.  The error is the rel-L2 on a 128 x 64 grid.

Usage: ``python -m pinn_torch.experiments.custom_pde_example [hp.json]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pinn_torch.api import PhysicsInformedNN
from pinn_torch.data import lhs
from pinn_torch.experiments._common import setup
from pinn_torch.utils import Logger, load_hp

ALPHA = 0.1

DEFAULT_HP = {
    "N_u": 100,
    "N_f": 5000,
    "layers": [2, 20, 20, 20, 20, 1],
    "tf_epochs": 500,
    "tf_lr": 0.005,
    "tf_b1": 0.9,
    "tf_eps": None,
    "nt_epochs": 2000,
    "nt_lr": 0.8,
    "nt_ncorr": 50,
    "nt_line_search": "wolfe",
    "log_frequency": 500,
}


def exact(X):
    return (np.exp(-ALPHA * np.pi ** 2 * X[:, 1:2])
            * np.sin(np.pi * X[:, 0:1]))


class HeatPINN(PhysicsInformedNN):
    def __init__(self, hp, logger, X_f, ub, lb, device=None):
        super().__init__(hp, logger, ub, lb, device=device)
        self.X_f = self.tensor(X_f)
        # Input-space tangents for the d/dx and d/dt streams.
        self.vx = self.tensor([1.0, 0.0])
        self.vt = self.tensor([0.0, 1.0])

    def extra_batch(self):
        return {"X_f": self.X_f}

    def loss(self, params, batch):
        u_pred = self.apply(params, batch["X_u"])
        mse_u = torch.mean(torch.square(batch["u"] - u_pred))
        o = self.taylor(params, batch["X_f"], self.vx, self.vt, order=2)
        f = o.d2 - ALPHA * o.d11          # u_t - alpha u_xx
        return mse_u + torch.mean(torch.square(f))


def run(hp=None, plot=False, save_path=None):
    """``plot`` and ``save_path`` are accepted for the experiments'
    signature; the example draws no figure, as in the JAX package."""
    hp = {**DEFAULT_HP, **(hp or {})}
    _, _, device = setup(hp)

    lb = np.array([-1.0, 0.0])
    ub = np.array([1.0, 1.0])

    # Training data: initial and boundary conditions only (the PINN
    # learns the interior from the residual).
    rng = np.random
    x0 = lb[0] + (ub[0] - lb[0]) * rng.rand(hp["N_u"] // 2, 1)
    X_ic = np.hstack([x0, np.zeros_like(x0)])
    tb = lb[1] + (ub[1] - lb[1]) * rng.rand(hp["N_u"] // 4, 1)
    X_bc = np.vstack([np.hstack([np.full_like(tb, lb[0]), tb]),
                      np.hstack([np.full_like(tb, ub[0]), tb])])
    X_u = np.vstack([X_ic, X_bc])
    u = exact(X_u)
    X_f = lb + (ub - lb) * lhs(2, hp["N_f"])

    logger = Logger(hp, device=device)
    pinn = HeatPINN(hp, logger, X_f, ub, lb, device=device)

    # Test grid.
    xs = np.linspace(lb[0], ub[0], 128)
    ts = np.linspace(lb[1], ub[1], 64)
    Xg, Tg = np.meshgrid(xs, ts)
    X_star = np.hstack([Xg.reshape(-1, 1), Tg.reshape(-1, 1)])
    u_star = exact(X_star)

    def error():
        u_pred = pinn.predict(X_star)
        return float(np.linalg.norm(u_star - u_pred, 2)
                     / np.linalg.norm(u_star, 2))

    logger.set_error_fn(error)
    pinn.fit(X_u, u)
    return {"error": error(), "pinn": pinn, "hp": hp}


if __name__ == "__main__":
    result = run(load_hp(sys.argv, DEFAULT_HP))
    print(f"rel-L2 error: {result['error']:.4e}")
