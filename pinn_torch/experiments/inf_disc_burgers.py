"""Discrete-time Burgers inference (q-stage IRK) on the PyTorch port.

Counterpart of ``experiments/inf_disc_burgers.py``, with the same
``DEFAULT_HP`` and ``run(hp) -> {"params", "u_1_pred", "error", "data",
"hp", "timing"}`` contract: a [1, 50x3, q+1] tanh MLP maps x to the q
IRK stage values and u(t1); q = 500, N_n = 250 points of the t0 = t[10]
snapshot; the backward IRK map U_0 = U_1 + dt (U U_x - nu U_xx) W^T;
loss = SSE(t0 data) + SSE(u at x = +-1); Adam then L-BFGS (Armijo);
the error is the rel-L2 of the predicted t1 = t[90] snapshot.  The
output width is set to q + 1 at run time, as in the JAX experiment.

- ``dtype: "float64"`` trains in float64; ``net_impl: "df32"`` (the JAX
  package's double-f32 engine) runs as native float64.
- ``device`` picks the device ("cuda", "cpu"; absent: "cuda", which
  raises without a card).
- ``tpu_mesh`` raises, as in the JAX experiment (250 points do not pay
  for sharding).
- ``plot=True`` draws ``plot_inf_disc_results``
  (``pinn_torch.experiments.viz``; needs matplotlib).

Usage: ``python -m pinn_torch.experiments.inf_disc_burgers [hp.json]
[--plot]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pinn_torch.data import burgers_disc_inference
from pinn_torch.dtypes import to_numpy
from pinn_torch.experiments._common import (check_no_mesh, command_line,
                                            maybe_load_params,
                                            maybe_save_params, setup)
from pinn_torch.models import mlp
from pinn_torch.problems import burgers
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger

DEFAULT_HP = {
    "N_n": 250,
    "q": 500,
    "layers": [1, 50, 50, 50, 501],
    "tf_epochs": 200,
    "tf_lr": 0.001,
    "tf_b1": 0.9,
    "tf_eps": 1e-8,
    "nt_epochs": 1000,
    "nt_lr": 0.8,
    "nt_ncorr": 50,
    "nt_line_search": "armijo",
    "log_frequency": 10,
}

IDX_T_0 = 10
IDX_T_1 = 90
LB, UB = np.array([-1.0]), np.array([1.0])   # every discrete family's x domain


def run(hp=None, plot=False, save_path=None):
    hp = {**DEFAULT_HP, **(hp or {})}
    check_no_mesh(hp)
    seed, dtype, device = setup(hp)
    hp["layers"] = list(hp["layers"])
    hp["layers"][-1] = hp["q"] + 1
    nu = 0.01 / np.pi
    data = burgers_disc_inference(hp["N_n"], hp["q"], LB, UB, IDX_T_0, IDX_T_1)

    def loss(p, b, lb, ub, irk_w):
        return burgers.loss_disc_inference(p, b["x_0"], b["u_0"], b["x_1"],
                                           lb, ub, nu, data.dt, irk_w)

    result = fit_disc_inference(hp, seed, dtype, device, data,
                                {"x_0": data.x_0, "u_0": data.u_0,
                                 "x_1": data.x_1}, loss)
    if plot:
        from pinn_torch.experiments.viz import plot_inf_disc_results
        plot_inf_disc_results(data.x_star, IDX_T_0, IDX_T_1, data.x_0,
                              data.u_0, UB, LB, result["u_1_pred"],
                              data.Exact_u, data.x, data.t,
                              save_path=save_path or "experiments",
                              save_hp=hp)
    return result


def fit_disc_inference(hp, seed, dtype, device, data, arrays, loss) -> dict:
    """Train a discrete-inference net on ``data`` (``IRK_weights``,
    ``x_star``, ``u_star``) and score its last output column, u(t1), on
    ``x_star``.  ``arrays`` are the batch's numpy arrays and
    ``loss(params, batch, lb, ub, irk_weights)`` the loss on [-1, 1];
    the tableau is cast to the run's dtype once, on the device."""

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    lb, ub = tensor(LB), tensor(UB)
    irk_w = tensor(data.IRK_weights)
    batch = {k: tensor(a) for k, a in arrays.items()}
    x_star = tensor(data.x_star)

    gen = torch.Generator().manual_seed(int(hp.get("init_seed") or seed))
    net = maybe_load_params(hp, mlp.init_mlp(hp["layers"], gen, dtype, device))

    def loss_fn(p, b):
        return loss(p, b, lb, ub, irk_w)

    @torch.no_grad()
    def predict_u1(p):
        return to_numpy(mlp.apply(p, x_star, lb, ub)[:, -1])

    logger = Logger(hp, device=device)
    trainer = Trainer(loss_fn, net, batch, hp, logger)

    def error():
        u_pred = predict_u1(trainer.params)
        return float(np.linalg.norm(u_pred - data.u_star, 2)
                     / np.linalg.norm(data.u_star, 2))

    logger.set_error_fn(error)
    params = trainer.fit()
    maybe_save_params(hp, params)
    return {"params": params, "u_1_pred": predict_u1(params),
            "error": error(), "data": data, "hp": hp,
            "timing": dict(trainer.timing)}


if __name__ == "__main__":
    hp, plot = command_line(sys.argv, DEFAULT_HP)
    result = run(hp, plot=plot)
    print(f"rel-L2 error (t1 snapshot): {result['error']:.4e}")
