"""Continuous-time Burgers identification on the PyTorch port: discover
lambda1 and lambda2.

Counterpart of ``experiments/ide_cont_burgers.py``, with the same
``DEFAULT_HP`` and ``run(hp) -> {"params", "lambdas", "lambdas_noisy",
"error", "u_pred", ...}`` contract: a [2, 20x8, 1] tanh MLP plus
trainable lambda1 (init 0) and log lambda2 (init -6), N_u = 2,000
points over the whole domain, the residual u_t + lambda1 u u_x -
exp(log lambda2) u_xx taken at the data points, Adam then L-BFGS.  It
trains the clean case and then the 1 %-noise case, from one init and
one numpy stream, so the data draws match the JAX package's; the
error is the clean case's mean relative lambda error.

- ``fused_residual: True`` trains on the fused loss
  (``pinn_torch.ops.fused_train.make_burgers_ide_loss``): the CUDA
  kernels on a CUDA device, their plain version on the CPU.  float32
  only.  ``fused_residual: "bf16"`` takes the bf16-stream kernels in
  both phases.
- ``tf_net_dtype: "bfloat16"`` on the eager loss: the Trainer casts the
  Adam phase's loss, as the JAX Trainer does.  With ``fused_residual``
  it raises: the JAX experiment keeps the key and casts the fused
  float32 loss, whose custom_vjp then hands float32 gradients back for
  bfloat16 parameters, so the network gradients escape the cast's
  bf16 rounding while the lambda gradients take it, and the kernel's
  inputs are prepared in bf16 arithmetic.  That mixture is not
  reproduced; ``fused_residual: "bf16"`` is the bf16 warmup on the
  kernels.
- ``dtype: "float64"`` trains on the eager loss.
- ``init_checkpoint``/``save_checkpoint`` are per case: the noisy case
  uses ``<path>-noisy.npz``.

``tpu_mesh`` raises, as in the JAX experiment (2,000 points do not pay
for sharding).  ``plot=True`` draws ``plot_ide_cont_results``
(``pinn_torch.experiments.viz``; needs matplotlib).

Usage: ``python -m pinn_torch.experiments.ide_cont_burgers [hp.json]
[--plot]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pinn_torch.data import burgers_cont_identification
from pinn_torch.dtypes import to_numpy
from pinn_torch.experiments._common import (check_no_mesh, command_line,
                                            maybe_load_params,
                                            maybe_save_params, setup,
                                            wants_bf16)
from pinn_torch.models import mlp
from pinn_torch.problems import burgers
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger

DEFAULT_HP = {
    "N_u": 2000,
    "layers": [2, 20, 20, 20, 20, 20, 20, 20, 20, 1],
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
    """One case: draw its data, build its loss, train.  Returns
    ``(params, data, lb, ub, timing)``."""
    data = burgers_cont_identification(hp["N_u"], noise=noise)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    lb, ub = tensor(data.lb), tensor(data.ub)
    batch = {"X_u": tensor(data.X_u_train), "u": tensor(data.u_train)}

    gen = torch.Generator().manual_seed(int(hp.get("init_seed") or seed))
    net = mlp.init_mlp(hp["layers"], gen, dtype, device)
    case = "noisy" if noise else None
    params0 = maybe_load_params(hp, burgers.init_ide_params(net, dtype), case)

    if hp.get("fused_residual"):
        if dtype != torch.float32:
            raise ValueError("fused_residual requires dtype=float32 "
                             "(the eager loss covers float64)")
        from pinn_torch.ops.fused_train import make_burgers_ide_loss
        sdt = "bfloat16" if wants_bf16(hp["fused_residual"]) else None
        loss_fn = make_burgers_ide_loss(data.lb, data.ub, stream_dtype=sdt)
    else:
        def loss_fn(p, b):
            return burgers.loss_cont_identification(p, b["X_u"], b["u"],
                                                    lb, ub)

    def epoch_extra(p):
        l1, l2 = get_lambdas(p)
        return f"l1 = {l1:5f}  l2 = {l2:8f}"

    trainer = Trainer(loss_fn, params0, batch, hp, logger,
                      epoch_extra=epoch_extra)
    logger.set_error_fn(lambda: lambda_error(trainer.params))
    params = trainer.fit()
    maybe_save_params(hp, params, case)
    return params, data, lb, ub, dict(trainer.timing)


def run(hp=None, plot=False, save_path=None):
    hp = {**DEFAULT_HP, **(hp or {})}
    check_no_mesh(hp)
    if hp.get("fused_residual") and hp.get("tf_net_dtype"):
        raise NotImplementedError(
            "tf_net_dtype with fused_residual is not reproduced: the JAX "
            "experiment casts the fused float32 loss to bf16 inputs, and "
            "its custom_vjp then returns float32 gradients for bfloat16 "
            "parameters, so the network gradients escape the cast's bf16 "
            "rounding while the lambda gradients take it; use "
            "fused_residual: \"bf16\" for a bf16 warmup on the kernels")
    seed, dtype, device = setup(hp)
    logger = Logger(hp, device=device)

    params, data, lb, ub, timing = train_once(hp, seed, dtype, device,
                                              noise=0.0, logger=logger)
    l1, l2 = get_lambdas(params)
    params_n, _, _, _, timing_n = train_once(hp, seed, dtype, device,
                                             noise=0.01, logger=logger)
    l1_noisy, l2_noisy = get_lambdas(params_n)

    print("l1: ", l1)
    print("l2: ", l2)
    print("l1_noise: ", l1_noisy)
    print("l2_noise: ", l2_noisy)

    with torch.no_grad():
        X_star = torch.as_tensor(data.X_star, dtype=dtype, device=device)
        u_pred = to_numpy(mlp.apply(params.net, X_star, lb, ub))
    if plot:
        from pinn_torch.experiments.viz import plot_ide_cont_results
        plot_ide_cont_results(data.X_star, u_pred, data.X_u_train,
                              data.u_train, data.Exact_u, data.X, data.T,
                              data.x, data.t, l1, l1_noisy, l2, l2_noisy,
                              save_path=save_path or "experiments",
                              save_hp=hp)
    return {"params": params, "params_noisy": params_n,
            "lambdas": (l1, l2), "lambdas_noisy": (l1_noisy, l2_noisy),
            "error": lambda_error(params), "u_pred": u_pred, "data": data,
            "hp": hp, "timing": {"clean": timing, "noisy": timing_n}}


if __name__ == "__main__":
    hp, plot = command_line(sys.argv, DEFAULT_HP)
    result = run(hp, plot=plot)
    print(f"mean relative lambda error: {result['error']:.4e}")
