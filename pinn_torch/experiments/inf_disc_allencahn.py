"""Discrete-time Allen–Cahn inference (q-stage IRK) on the PyTorch port.

Counterpart of ``experiments/inf_disc_allencahn.py``, with the same
``DEFAULT_HP`` and ``run(hp)`` contract as ``inf_disc_burgers``:

    u_t - 0.0001 u_xx + 5 u^3 - 5 u = 0,  x in [-1, 1) periodic,

one q = 100-stage Gauss–Legendre IRK step from the t[20] = 0.1
snapshot to t[180] = 0.9 (dt = 0.8), a [1, 200x4, q+1] tanh MLP,
N_n = 200 sample points, loss = SSE(t0 data) + SSE(periodic value
gap) + SSE(periodic derivative gap); the error is the rel-L2 of the
predicted t1 snapshot.  ``noise`` (default 0) perturbs the t0 samples
by that fraction of their std; the numpy stream draws the noise only
when it is positive, as in the JAX experiment.

The data are read from ``data/AC.npz`` (keys ``x``, ``tt``, ``uu``;
``uu`` space-major); a missing file is generated first
(``pinn_torch.datagen.allencahn_exact``), as in the JAX experiment.

- ``dtype: "float64"``; ``net_impl: "df32"`` runs as native float64.
- ``tpu_mesh`` raises, as in the JAX experiment.
- ``plot=True`` draws ``plot_inf_disc_results``
  (``pinn_torch.experiments.viz``; needs matplotlib).

Usage: ``python -m pinn_torch.experiments.inf_disc_allencahn [hp.json]``
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple

import numpy as np

from pinn_torch import irk
from pinn_torch.data import DATA_DIR, load_snapshots
from pinn_torch.experiments._common import check_no_mesh, command_line, setup
from pinn_torch.experiments.inf_disc_burgers import (LB, UB,
                                                     fit_disc_inference)
from pinn_torch.problems import allencahn

DEFAULT_HP = {
    "N_n": 200,
    "q": 100,
    "layers": [1, 200, 200, 200, 200, 101],
    "tf_epochs": 1000,
    "tf_lr": 0.001,
    "tf_b1": 0.9,
    "tf_eps": 1e-8,
    "nt_epochs": 10000,
    "nt_lr": 0.8,
    "nt_ncorr": 50,
    "nt_line_search": "armijo",
    "log_frequency": 10,
}

IDX_T_0 = 20   # t = 0.1
IDX_T_1 = 180  # t = 0.9
DATASET = os.path.join(DATA_DIR, "AC.npz")


class AllenCahnDisc(NamedTuple):
    x_0: np.ndarray        # (N_n, 1) sample locations at t0
    u_0: np.ndarray        # (N_n, 1) snapshot values (+ optional noise)
    x_bnd: np.ndarray      # (2, 1) periodic boundary pair [lb; ub]
    dt: float
    IRK_weights: np.ndarray  # (q+1, q)
    x_star: np.ndarray     # (nx, 1) full grid
    u_star: np.ndarray     # (nx,) exact t1 snapshot
    Exact_u: np.ndarray    # (nx, nt)
    x: np.ndarray          # (nx, 1)
    t: np.ndarray          # (nt, 1)


def load_dataset():
    """-> x (nx, 1), t (nt, 1), uu (nx, nt) from ``data/AC.npz``, which is
    generated (``pinn_torch.datagen.allencahn_exact``) and written first where it
    is missing, as in the JAX experiment."""
    if not os.path.exists(DATASET):
        from pinn_torch.datagen.allencahn_exact import generate
        generate(DATASET)
    return load_snapshots(DATASET)


def prep_data(N_n: int, q: int, idx_t_0: int = IDX_T_0,
              idx_t_1: int = IDX_T_1, noise: float = 0.0) -> AllenCahnDisc:
    x, t, Exact = load_dataset()
    dt = float(t[idx_t_1, 0] - t[idx_t_0, 0])

    idx_x = np.random.choice(Exact.shape[0], N_n, replace=False)
    x_0 = x[idx_x, :]
    u_0 = Exact[idx_x, idx_t_0][:, None]
    if noise > 0.0:
        u_0 = u_0 + noise * np.std(u_0) * np.random.randn(*u_0.shape)

    weights, _ = irk.irk_weights(q)
    return AllenCahnDisc(x_0=x_0, u_0=u_0,
                         x_bnd=np.array([[-1.0], [1.0]]),
                         dt=dt, IRK_weights=weights,
                         x_star=x, u_star=Exact[:, idx_t_1],
                         Exact_u=Exact, x=x, t=t)


def run(hp=None, plot=False, save_path=None):
    hp = {**DEFAULT_HP, **(hp or {})}
    check_no_mesh(hp)
    seed, dtype, device = setup(hp)
    hp["layers"] = list(hp["layers"])
    hp["layers"][-1] = hp["q"] + 1
    data = prep_data(hp["N_n"], hp["q"], noise=hp.get("noise", 0.0))

    def loss(p, b, lb, ub, irk_w):
        return allencahn.loss_disc_inference(p, b["x_0"], b["u_0"],
                                             b["x_bnd"], lb, ub, data.dt,
                                             irk_w)

    result = fit_disc_inference(hp, seed, dtype, device, data,
                                {"x_0": data.x_0, "u_0": data.u_0,
                                 "x_bnd": data.x_bnd}, loss)
    if plot:
        from pinn_torch.experiments.viz import plot_inf_disc_results
        # The shared disc figure wants Exact_u time-major (Nt, Nx).
        plot_inf_disc_results(data.x_star, IDX_T_0, IDX_T_1, data.x_0,
                              data.u_0, UB, LB, result["u_1_pred"],
                              data.Exact_u.T, data.x, data.t,
                              save_path=save_path or "experiments",
                              save_hp=hp)
    return result


if __name__ == "__main__":
    hp, plot = command_line(sys.argv, DEFAULT_HP)
    result = run(hp, plot=plot)
    print(f"rel-L2 error (t1 snapshot): {result['error']:.4e}")
