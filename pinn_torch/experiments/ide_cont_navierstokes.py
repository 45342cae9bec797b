"""2D Navier–Stokes identification on the PyTorch port: discover lambda1
(advection) and lambda2 (viscosity) from velocity samples.

Counterpart of ``experiments/ide_cont_navierstokes.py``, with the same
``DEFAULT_HP`` and ``run(hp) -> {"params", "params_noisy", "lambdas",
"lambdas_noisy", "error", "field_errors", "data", "hp", "timing"}``
contract: a [3, 20x8, 2] psi–p net plus raw trainables lambda1, lambda2
(init 0), N_u samples of (u, v) over the space-time box, the momentum
residuals from the 13-stream pass of
``pinn_torch.problems.navierstokes``, Adam then L-BFGS, a clean and a
1 %-noise case; the error is the clean case's mean relative lambda
error, and ``field_errors`` the clean net's rel-L2 of u, v and the
gauge-adjusted p on the full grid.

- The data: the pseudo-spectral DNS of decaying 2D turbulence
  (``pinn_torch.datagen.navierstokes_spectral``, grid 128 x 128 x 41 by
  default), generated on each run as the JAX experiment does;
  ``dataset: "taylor-green"`` takes the exact vortex instead (grid 64 x
  64 x 21; lambda1 is not identifiable there).  ``grid_nx``,
  ``grid_ny``, ``grid_nt`` and ``t_max`` size either.
- The draws: each case makes ``np.random.default_rng(seed)`` afresh, so
  the clean and noisy cases sample the same points; ``nt_val_every``'s
  validation set continues that generator after the training draw;
  ``N_f`` adds an LHS draw from ``np.random.RandomState(seed + 7919)``
  and takes the residuals on ``vstack([X, draw])``.
- ``net_impl: "df32"`` (the JAX package's double-f32 engine) requires
  ``dtype: "float64"`` and runs as native float64.
- ``init_checkpoint``/``save_checkpoint`` are per case: the noisy case
  uses ``<path>-noisy.npz``.

``tpu_mesh`` raises, as in the JAX experiment.  ``plot=True`` draws
``plot_ide_navierstokes_results`` (``pinn_torch.experiments.viz``;
needs matplotlib).

Usage: ``python -m pinn_torch.experiments.ide_cont_navierstokes [hp.json]
[--plot]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pinn_torch.data import lhs
from pinn_torch.datagen import navierstokes_exact, navierstokes_spectral
from pinn_torch.datagen.navierstokes_exact import NU_STAR
from pinn_torch.dtypes import to_numpy
from pinn_torch.experiments._common import (command_line, maybe_load_params,
                                            maybe_save_params, setup)
from pinn_torch.models import mlp
from pinn_torch.problems import navierstokes as ns
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger

DEFAULT_HP = {
    "N_u": 5000,
    "layers": [3, 20, 20, 20, 20, 20, 20, 20, 20, 2],
    "tf_epochs": 100,
    "tf_lr": 0.001,
    "tf_b1": 0.9,
    "tf_eps": None,
    "nt_epochs": 500,
    "nt_lr": 0.8,
    "nt_ncorr": 50,
    "nt_line_search": "armijo",
    "log_frequency": 10,
}

LAMBDAS_STAR = (1.0, NU_STAR)


def get_lambdas(params: ns.NSIdeParams):
    """(lambda1, lambda2) as Python floats (a host copy)."""
    return float(params.lambda1[0]), float(params.lambda2[0])


def lambda_error(params) -> float:
    l1, l2 = get_lambdas(params)
    l1s, l2s = LAMBDAS_STAR
    return float((abs(l1 - l1s) / l1s + abs(l2 - l2s) / l2s) / 2)


def sample_training_set(data, N_u: int, noise: float, rng):
    """N_u random space-time samples of (u, v) from the generator
    ``rng``; with ``noise``, noise * std Gaussian noise on each."""
    idx = rng.choice(data.X_star.shape[0], N_u, replace=False)
    X = data.X_star[idx]
    u = data.u_star[idx]
    v = data.v_star[idx]
    if noise:
        u = u + noise * u.std() * rng.standard_normal(u.shape)
        v = v + noise * v.std() * rng.standard_normal(v.shape)
    return X, u, v


def collocation_set(data, X, N_f: int, seed: int) -> np.ndarray:
    """The separate residual set: the data points, then an LHS draw of
    ``N_f`` points over the space-time box."""
    rs = np.random.RandomState(seed + 7919)
    draw = data.lb + (data.ub - data.lb) * lhs(3, N_f, rs)
    return np.vstack([X, draw])


def train_once(hp, seed, dtype, device, data, noise: float, logger):
    """One case: draw its points, build its loss, train.  Returns
    ``(params, timing)``."""
    rng = np.random.default_rng(seed)
    X, u, v = sample_training_set(data, hp["N_u"], noise, rng)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    lb, ub = tensor(data.lb), tensor(data.ub)
    batch = {"X": tensor(X), "u": tensor(u), "v": tensor(v)}
    if hp.get("N_f"):
        batch["X_f"] = tensor(collocation_set(data, X, hp["N_f"], seed))

    gen = torch.Generator().manual_seed(int(hp.get("init_seed") or seed))
    net = mlp.init_mlp(hp["layers"], gen, dtype, device)
    case = "noisy" if noise else None
    params0 = maybe_load_params(hp, ns.init_ide_params(net, dtype), case)

    def loss_fn(p, b):
        return ns.loss_identification(p, b["X"], b["u"], b["v"], lb, ub,
                                      X_f=b.get("X_f"))

    def epoch_extra(p):
        l1, l2 = get_lambdas(p)
        return f"l1 = {l1:5f}  l2 = {l2:8f}"

    val_fn = None
    if hp.get("nt_val_every"):
        # The same loss on an independent draw of measured (u, v) at the
        # training noise level; the lambda targets are never read.
        X_v, u_v, v_v = sample_training_set(data, min(hp["N_u"], 5000),
                                            noise, rng)
        bv = {"X": tensor(X_v), "u": tensor(u_v), "v": tensor(v_v)}

        @torch.no_grad()
        def val_fn(p):
            return float(ns.loss_identification(p, bv["X"], bv["u"],
                                                bv["v"], lb, ub))

    trainer = Trainer(loss_fn, params0, batch, hp, logger,
                      epoch_extra=epoch_extra, val_fn=val_fn)
    logger.set_error_fn(lambda: lambda_error(trainer.params))
    params = trainer.fit()
    maybe_save_params(hp, params, case)
    return params, dict(trainer.timing)


@torch.no_grad()
def field_errors(params, data, dtype, device, chunk: int = 16384):
    """Relative L2 of (u, v) and the gauge-adjusted p on the full grid,
    predicted ``chunk`` points at a time; returns ``(errors, (u, v,
    p_adj))``."""
    lb = torch.as_tensor(data.lb, dtype=dtype, device=device)
    ub = torch.as_tensor(data.ub, dtype=dtype, device=device)
    us, vs, ps = [], [], []
    for i in range(0, data.X_star.shape[0], chunk):
        X = torch.as_tensor(data.X_star[i:i + chunk], dtype=dtype,
                            device=device)
        u, v, p = ns.predict_uvp(params.net, X, lb, ub)
        us.append(to_numpy(u)); vs.append(to_numpy(v))
        ps.append(to_numpy(p))
    u = np.concatenate(us); v = np.concatenate(vs); p = np.concatenate(ps)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # Pressure enters the PDE only through its gradient: remove the gauge
    # constant before comparing (Raissi et al. 2019 §4.1.1 does the same).
    p_adj = p - p.mean() + data.p_star.mean()
    return {"u": rel(u, data.u_star), "v": rel(v, data.v_star),
            "p": rel(p_adj, data.p_star)}, (u, v, p_adj)


def run(hp=None, plot=False, save_path=None):
    hp = {**DEFAULT_HP, **(hp or {})}
    if hp.get("tpu_mesh"):
        raise ValueError("tpu_mesh is not supported by this experiment "
                         "(residual at the N_u data points only; see "
                         "PARITY.md S2.5)")
    seed, dtype, device = setup(hp)
    logger = Logger(hp, device=device)
    if hp.get("dataset", "spectral") == "taylor-green":
        data = navierstokes_exact.generate(
            nx=hp.get("grid_nx", 64), ny=hp.get("grid_ny", 64),
            nt=hp.get("grid_nt", 21), t_max=hp.get("t_max", 2.0))
    else:
        data = navierstokes_spectral.generate(
            nx=hp.get("grid_nx", 128), ny=hp.get("grid_ny", 128),
            nt=hp.get("grid_nt", 41), t_max=hp.get("t_max", 2.0))

    params, timing = train_once(hp, seed, dtype, device, data, noise=0.0,
                                logger=logger)
    l1, l2 = get_lambdas(params)
    params_n, timing_n = train_once(hp, seed, dtype, device, data,
                                    noise=0.01, logger=logger)
    l1_noisy, l2_noisy = get_lambdas(params_n)

    print("l1: ", l1)
    print("l2: ", l2)
    print("l1_noise: ", l1_noisy)
    print("l2_noise: ", l2_noisy)

    errs, (u_pred, v_pred, p_pred) = field_errors(params, data, dtype, device)
    print(f"rel-L2  u: {errs['u']:.4e}  v: {errs['v']:.4e}  "
          f"p (gauge-adjusted): {errs['p']:.4e}")
    if plot:
        from pinn_torch.experiments.viz import plot_ide_navierstokes_results
        plot_ide_navierstokes_results(
            data, u_pred, v_pred, p_pred, l1, l1_noisy, l2, l2_noisy,
            save_path=save_path or "experiments", save_hp=hp)
    return {"params": params, "params_noisy": params_n,
            "lambdas": (l1, l2), "lambdas_noisy": (l1_noisy, l2_noisy),
            "error": lambda_error(params), "field_errors": errs,
            "data": data, "hp": hp,
            "timing": {"clean": timing, "noisy": timing_n}}


if __name__ == "__main__":
    hp, plot = command_line(sys.argv, DEFAULT_HP)
    result = run(hp, plot=plot)
    print(f"mean relative lambda error: {result['error']:.4e}")
