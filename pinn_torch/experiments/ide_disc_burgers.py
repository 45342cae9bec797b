"""Discrete-time Burgers identification across two snapshots on the
PyTorch port.

Counterpart of ``experiments/ide_disc_burgers.py``, with the same
``DEFAULT_HP``: a [1, 50x3, q] tanh MLP of the IRK stage values, q
from ``irk.auto_stages(dt)`` (81 at dt = 0.8), trainable lambda1 and
log lambda2 (inits 0 and -6), the stage maps
U_0 = U + dt N alpha^T and U_1 = U + dt (-N)(beta - alpha)^T with
N = lambda1 U U_x - exp(log lambda2) U_xx, loss = SSE to the t[10] and
t[90] snapshots (N_0 = 199, N_1 = 201 points), Adam then L-BFGS
(Armijo).  It trains the clean case and then the 1 %-noise case, from
one init and one numpy stream, so the data draws match the JAX
package's.  ``run(hp)`` returns ``lambdas``, ``lambdas_noisy``, the
clean case's stage-map predictions ``U_0_pred``, ``U_1_pred`` on the
full grid, its mean relative lambda ``error``, ``params``,
``params_noisy`` and each case's ``timing``.

- ``dtype: "float64"`` trains in float64; ``net_impl: "df32"`` runs as
  native float64.
- ``init_checkpoint``/``save_checkpoint`` are per case: the noisy case
  uses ``<path>-noisy.npz``.
- ``tpu_mesh`` raises, as in the JAX experiment.
- ``plot=True`` draws ``plot_ide_disc_results``
  (``pinn_torch.experiments.viz``; needs matplotlib).

Usage: ``python -m pinn_torch.experiments.ide_disc_burgers [hp.json]
[--plot]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pinn_torch.data import burgers_disc_identification
from pinn_torch.dtypes import to_numpy
from pinn_torch.experiments._common import (check_no_mesh, command_line,
                                            maybe_load_params,
                                            maybe_save_params, setup)
from pinn_torch.models import mlp
from pinn_torch.problems import burgers
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger

DEFAULT_HP = {
    "N_0": 199,
    "N_1": 201,
    "layers": [1, 50, 50, 50, 0],  # output width set to q at run time
    "tf_epochs": 100,
    "tf_lr": 0.001,
    "tf_b1": 0.9,
    "tf_eps": None,
    "nt_epochs": 2000,
    "nt_lr": 0.8,
    "nt_ncorr": 50,
    "nt_line_search": "armijo",
    "log_frequency": 10,
}

IDX_T_0 = 10
SKIP = 80
LAMBDAS_STAR = (1.0, 0.01 / np.pi)


def get_lambdas(params: burgers.IdeParams):
    """(lambda1, lambda2) as Python floats (a host copy)."""
    return (float(params.lambda1[0]),
            float(torch.exp(params.log_lambda2[0])))


def lambda_error(params) -> float:
    l1, l2 = get_lambdas(params)
    l1s, l2s = LAMBDAS_STAR
    return float((abs(l1 - l1s) / l1s + abs(l2 - l2s) / l2s) / 2)


def train_once(hp, seed, dtype, device, noise: float, logger):
    """One case: draw its data, train.  Returns ``(params, data,
    predict_stages, timing)``."""
    data = burgers_disc_identification(hp["N_0"], hp["N_1"], IDX_T_0,
                                       IDX_T_0 + SKIP, noise=noise)
    return fit_case(hp, seed, dtype, device, data, burgers, lambda_error,
                    noise, logger)


def fit_case(hp, seed, dtype, device, data, problem, error_fn, noise,
             logger):
    """Train one case of a discrete identification on ``data`` (two
    snapshots and the IRK tableau) with ``problem``'s loss and stage
    maps (``pinn_torch.problems.burgers`` or ``kdv``).  The output
    width becomes ``data.q``.  Returns ``(params, data, predict_stages,
    timing)``; ``predict_stages(params, x)`` gives (U_0, U_1) as numpy."""
    hp["layers"] = list(hp["layers"])
    hp["layers"][-1] = data.q

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    lb, ub = tensor([-1.0]), tensor([1.0])
    alpha, beta = tensor(data.IRK_alpha), tensor(data.IRK_beta)
    batch = {"x_0": tensor(data.x_0), "u_0": tensor(data.u_0),
             "x_1": tensor(data.x_1), "u_1": tensor(data.u_1)}

    gen = torch.Generator().manual_seed(int(hp.get("init_seed") or seed))
    net = mlp.init_mlp(hp["layers"], gen, dtype, device)
    case = "noisy" if noise else None
    params0 = maybe_load_params(hp, problem.init_ide_params(net, dtype), case)

    def loss_fn(p, b):
        return problem.loss_disc_identification(
            p, b["x_0"], b["u_0"], b["x_1"], b["u_1"], lb, ub, data.dt,
            alpha, beta)

    def epoch_extra(p):
        l1, l2 = get_lambdas(p)
        return f"l1 = {l1:5f}  l2 = {l2:8f}"

    trainer = Trainer(loss_fn, params0, batch, hp, logger,
                      epoch_extra=epoch_extra)
    logger.set_error_fn(lambda: error_fn(trainer.params))
    params = trainer.fit()
    maybe_save_params(hp, params, case)

    @torch.no_grad()
    def predict_stages(p, x):
        return tuple(to_numpy(a) for a in problem.disc_ide_stage_maps(
            p, tensor(x), lb, ub, data.dt, alpha, beta))

    return params, data, predict_stages, dict(trainer.timing)


def run_cases(hp, train_once, error_fn) -> dict:
    """The clean case, then the 1 %-noise case on the same numpy
    stream; ``train_once`` is the experiment's."""
    check_no_mesh(hp)
    seed, dtype, device = setup(hp)
    logger = Logger(hp, device=device)

    params, data, predict_stages, timing = train_once(
        hp, seed, dtype, device, 0.0, logger)
    l1, l2 = get_lambdas(params)
    U_0_pred, U_1_pred = predict_stages(params, data.x)
    params_n, _, _, timing_n = train_once(hp, seed, dtype, device, 0.01,
                                          logger)
    l1_noisy, l2_noisy = get_lambdas(params_n)

    print("l1: ", l1)
    print("l2: ", l2)
    print("noisy l1: ", l1_noisy)
    print("noisy l2: ", l2_noisy)
    return {"params": params, "params_noisy": params_n,
            "lambdas": (l1, l2), "lambdas_noisy": (l1_noisy, l2_noisy),
            "U_0_pred": U_0_pred, "U_1_pred": U_1_pred,
            "error": error_fn(params), "data": data, "hp": hp,
            "timing": {"clean": timing, "noisy": timing_n}}


def plot_cases(result, idx_t_0, idx_t_1, save_path, **kw) -> None:
    """The identification figure of ``run_cases``' result, whose
    snapshots are the grid's times ``idx_t_0`` and ``idx_t_1``."""
    from pinn_torch.experiments.viz import plot_ide_disc_results
    data = result["data"]
    (l1, l2), (l1_noisy, l2_noisy) = (result["lambdas"],
                                      result["lambdas_noisy"])
    plot_ide_disc_results(data.x, data.t, idx_t_0, idx_t_1,
                          data.x_0, data.u_0, data.x_1, data.u_1,
                          np.array([1.0]), np.array([-1.0]),
                          data.Exact_u, l1, l1_noisy, l2, l2_noisy,
                          save_path=save_path or "experiments",
                          save_hp=result["hp"], **kw)


def run(hp=None, plot=False, save_path=None):
    result = run_cases({**DEFAULT_HP, **(hp or {})}, train_once,
                       lambda_error)
    if plot:
        plot_cases(result, IDX_T_0, IDX_T_0 + SKIP, save_path)
    return result


if __name__ == "__main__":
    hp, plot = command_line(sys.argv, DEFAULT_HP)
    result = run(hp, plot=plot)
    print(f"mean relative lambda error: {result['error']:.4e}")
