"""Discrete-time KdV identification across two snapshots on the
PyTorch port.

Counterpart of ``experiments/ide_disc_kdv.py``, with the same
``DEFAULT_HP`` and ``run(hp)`` contract as ``ide_disc_burgers``:

    u_t + lambda1 u u_x + lambda2 u_xxx = 0,   lambda* = (1, 0.0025),

recovering (lambda1, lambda2) from the t[40] = 0.2 and t[160] = 0.8
snapshots bridged by one q = 50-stage Gauss–Legendre IRK step
(dt = 0.6); a [1, 50x3, q] tanh MLP of the stage values, u_xxx from the
order-3 stream of the same Taylor pass, trainable lambda1 and
log lambda2, loss = SSE to both snapshots (N_0 = 199, N_1 = 201);
clean and 1 %-noise cases; the error is the clean case's mean relative
lambda error.  float32 by default, as the JAX recipe is.

The data are read from ``data/KdV.npz`` (keys ``x``, ``tt``, ``uu``;
``uu`` space-major).  Unlike Allen–Cahn's, this ``prep_data`` draws
the noise of both snapshots even at noise 0, as the JAX one does, so
the numpy stream stays the same.  A missing file is generated first
(``pinn_torch.datagen.kdv_exact``), as in the JAX experiment.
``plot=True`` draws ``plot_ide_disc_results`` with the u_xxx term
(``pinn_torch.experiments.viz``; needs matplotlib).

Usage: ``python -m pinn_torch.experiments.ide_disc_kdv [hp.json]
[--plot]``
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple

import numpy as np

from pinn_torch import irk
from pinn_torch.data import DATA_DIR, load_snapshots
from pinn_torch.experiments._common import command_line
from pinn_torch.experiments.ide_disc_burgers import (fit_case, plot_cases,
                                                     run_cases)
from pinn_torch.problems import kdv

DEFAULT_HP = {
    "N_0": 199,
    "N_1": 201,
    "q": 50,
    "layers": [1, 50, 50, 50, 0],  # output width set to q at run time
    "tf_epochs": 200,
    "tf_lr": 0.001,
    "tf_b1": 0.9,
    "tf_eps": None,
    "nt_epochs": 10000,
    "nt_lr": 0.8,
    "nt_ncorr": 50,
    "nt_line_search": "armijo",
    "log_frequency": 10,
}

IDX_T_0 = 40   # t = 0.2
IDX_T_1 = 160  # t = 0.8
LAMBDAS_STAR = (kdv.LAMBDA1_STAR, kdv.LAMBDA2_STAR)
DATASET = os.path.join(DATA_DIR, "KdV.npz")


class KdVDiscIde(NamedTuple):
    x_0: np.ndarray        # (N_0, 1)
    u_0: np.ndarray        # (N_0, 1)
    x_1: np.ndarray        # (N_1, 1)
    u_1: np.ndarray        # (N_1, 1)
    dt: float
    q: int
    IRK_alpha: np.ndarray  # (q, q)
    IRK_beta: np.ndarray   # (1, q)
    x: np.ndarray          # (nx, 1)
    t: np.ndarray          # (nt, 1)
    Exact_u: np.ndarray    # (nx, nt)


def load_dataset():
    """-> x (nx, 1), t (nt, 1), uu (nx, nt) from ``data/KdV.npz``, which is
    generated (``pinn_torch.datagen.kdv_exact``) and written first where it
    is missing, as in the JAX experiment."""
    if not os.path.exists(DATASET):
        from pinn_torch.datagen.kdv_exact import generate
        generate(DATASET)
    return load_snapshots(DATASET)


def prep_data(N_0: int, N_1: int, q: int, idx_t_0: int = IDX_T_0,
              idx_t_1: int = IDX_T_1, noise: float = 0.0) -> KdVDiscIde:
    """Two-snapshot sampling in the Burgers identification's draw order:
    the t0 indices and noise, then the t1 indices and noise."""
    x, t, Exact = load_dataset()
    dt = float(t[idx_t_1, 0] - t[idx_t_0, 0])

    idx_x = np.random.choice(Exact.shape[0], N_0, replace=False)
    x_0 = x[idx_x, :]
    u_0 = Exact[idx_x, idx_t_0][:, None]
    u_0 = u_0 + noise * np.std(u_0) * np.random.randn(*u_0.shape)

    idx_x = np.random.choice(Exact.shape[0], N_1, replace=False)
    x_1 = x[idx_x, :]
    u_1 = Exact[idx_x, idx_t_1][:, None]
    u_1 = u_1 + noise * np.std(u_1) * np.random.randn(*u_1.shape)

    weights, _ = irk.irk_weights(q)
    return KdVDiscIde(x_0, u_0, x_1, u_1, dt, q, Exact_u=Exact, x=x, t=t,
                      IRK_alpha=weights[:-1, :], IRK_beta=weights[-1:, :])


def train_once(hp, seed, dtype, device, noise: float, logger):
    """One case: draw its data, train.  Returns ``(params, data,
    predict_stages, timing)``."""
    data = prep_data(hp["N_0"], hp["N_1"], hp["q"], noise=noise)
    return fit_case(hp, seed, dtype, device, data, kdv, kdv.lambda_error,
                    noise, logger)


def run(hp=None, plot=False, save_path=None):
    result = run_cases({**DEFAULT_HP, **(hp or {})}, train_once,
                       kdv.lambda_error)
    if plot:
        plot_cases(result, IDX_T_0, IDX_T_1, save_path,
                   lambda2_star=kdv.LAMBDA2_STAR, deriv="u_{xxx}")
    return result


if __name__ == "__main__":
    hp, plot = command_line(sys.argv, DEFAULT_HP)
    result = run(hp, plot=plot)
    print(f"mean relative lambda error: {result['error']:.4e}")
