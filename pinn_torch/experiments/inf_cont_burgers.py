"""Continuous-time 1D Burgers inference on the PyTorch port.

Counterpart of ``experiments/inf_cont_burgers.py``, with the same
``DEFAULT_HP`` and ``run(hp) -> {"params", "error", ...}`` contract:
[2, 20x8, 1] tanh MLP, N_u = 100 boundary/initial points, N_f = 10,000
LHS collocation points, loss = MSE(data) + MSE(u_t + u u_x - nu u_xx),
nu = 0.01/pi, Adam then L-BFGS, rel-L2 error on the full grid.

- ``fused_residual: True`` trains on the fused loss
  (``pinn_torch.ops.fused_train``): the CUDA kernels on a CUDA device,
  their plain PyTorch version on the CPU.  float32 only.
  ``fused_residual: "bf16"`` takes the bf16-stream kernels in both
  phases.
- ``tf_net_dtype: "bfloat16"`` (the bf16 warmup): on the fused path
  the Adam phase trains on the bf16-stream kernels and L-BFGS on the
  f32 ones, and the key leaves hp before it is logged, as in the JAX
  experiment; on the eager path the Trainer casts the Adam phase's loss
  (``pinn_torch.optim.adam.net_dtype_cast``).
- ``dtype: "float64"`` trains on the eager loss; ``net_impl: "df32"``
  (the JAX package's double-f32 engine) runs as native float64.
- ``device`` picks the device ("cuda", "cpu"; absent: "cuda").  Without
  a card, "cuda" raises: the CPU runs only when asked for.
- ``rar_pool: M`` (residual-based adaptive refinement): every
  resampling (``tf_resample``/``nt_resample``) draws M LHS candidates,
  keeps the N_f // 2 with the largest |f| under the current iterate and
  fills the rest uniformly from the others; ``rar_init: true`` with
  ``rar_pool`` makes one such draw from the starting net before
  training (a warm-started refinement stage).  The numpy streams are
  the JAX experiment's, so the draws are the same.  Points are scored
  by ``_common.residual_fn``: in float32 the residual-evaluation kernel,
  in float64 the eager residual.

- ``tpu_mesh`` (``true``: every visible card; an int: that many, or
  with ``device: "cpu"`` that many CPU shards) splits the collocation
  axis over a ``pinn_torch.parallel`` mesh of D shards.  With
  ``fused_residual`` each shard launches the fused kernels on its N_f/D
  rows (``make_burgers_loss_dp``; N_f must divide); without it X_f is
  padded to a multiple of D with zero weights (``f_w``) and each shard
  runs the eager loss on its rows with weights ×D.  The shards are
  summed in a fixed order and divided by D.  ``rar_init`` draws only
  without a mesh, as in the JAX experiment.
- ``plot=True`` draws ``plot_inf_cont_results``
  (``pinn_torch.experiments.viz``; needs matplotlib) under
  ``save_path`` (default ``experiments``, against the repo root).

Usage: ``python -m pinn_torch.experiments.inf_cont_burgers [hp.json]
[--plot]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pinn_torch.data import burgers_cont_inference, lhs
from pinn_torch.dtypes import to_numpy
from pinn_torch.experiments._common import (command_line, maybe_load_params,
                                            maybe_save_params, resolve_mesh,
                                            residual_fn, setup, wants_bf16)
from pinn_torch.models import mlp
from pinn_torch.problems import burgers
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger

DEFAULT_HP = {
    "N_u": 100,
    "N_f": 10000,
    "layers": [2, 20, 20, 20, 20, 20, 20, 20, 20, 1],
    "tf_epochs": 100,
    "tf_lr": 0.03,
    "tf_b1": 0.9,
    "tf_eps": None,
    "nt_epochs": 200,
    "nt_lr": 0.8,
    "nt_ncorr": 50,
    "nt_line_search": "armijo",
    "log_frequency": 10,
}


def run(hp=None, plot=False, save_path=None):
    hp = {**DEFAULT_HP, **(hp or {})}
    seed, dtype, device = setup(hp)
    if hp.get("rar_pool") and int(hp["rar_pool"]) < hp["N_f"]:
        raise ValueError(
            f"rar_pool ({hp['rar_pool']}) must be >= N_f ({hp['N_f']}): "
            "the RAR draw keeps N_f points out of the candidate pool")

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def padded(X):
        from pinn_torch.parallel import pad_points_with_weights
        Xp, w = pad_points_with_weights(np.asarray(X), mesh.size)
        return tensor(Xp), tensor(w)

    data = burgers_cont_inference(hp["N_u"], hp["N_f"])
    lb, ub = tensor(data.lb), tensor(data.ub)
    X_u, u, X_f = tensor(data.X_u_train), tensor(data.u_train), tensor(data.X_f)
    X_star = tensor(data.X_star)
    nu = 0.01 / np.pi

    gen = torch.Generator().manual_seed(int(hp.get("init_seed") or seed))
    net = maybe_load_params(hp, mlp.init_mlp(hp["layers"], gen, dtype, device))

    mesh = resolve_mesh(hp, device)
    pad = mesh is not None and not hp.get("fused_residual")
    batch = {"X_u": X_u, "u": u, "X_f": X_f}
    if pad:
        # Eager mesh path: zero-weight pad rows so any N_f divides the
        # mesh (the fused DP path requires N_f % D == 0 instead).
        X_f, batch["f_w"] = padded(data.X_f)
        batch["X_f"] = X_f

    adam_loss_fn = None  # the Adam phase's loss, when it differs
    if hp.get("fused_residual"):
        if dtype != torch.float32:
            raise ValueError("fused_residual requires dtype=float32 "
                             "(the eager loss covers float64)")
        from pinn_torch.ops.fused_train import (make_burgers_loss,
                                                make_burgers_loss_dp)

        def build_fused(stream):
            if mesh is not None:
                return make_burgers_loss_dp(data.lb, data.ub, nu, mesh,
                                            stream_dtype=stream)
            return make_burgers_loss(data.lb, data.ub, nu, stream_dtype=stream)

        loss_fn = build_fused("bfloat16" if wants_bf16(hp["fused_residual"])
                              else None)
        if wants_bf16(hp.get("tf_net_dtype")):
            # bf16 warmup on the fused path: Adam on the bf16-stream
            # kernels (float32 weights and gradients, so no cast on
            # top), L-BFGS on loss_fn; the key is not logged.
            adam_loss_fn = build_fused("bfloat16")
            hp = {k: v for k, v in hp.items() if k != "tf_net_dtype"}
    else:
        def loss_fn(p, b):
            return burgers.loss_cont_inference(p, b["X_u"], b["u"], b["X_f"],
                                               lb, ub, nu,
                                               f_weights=b.get("f_w"))

        if mesh is not None:
            from pinn_torch.parallel import data_parallel
            eager = loss_fn

            def local_loss(p, b):   # a shard's rows, its weights x D
                return eager(p, {**b, "f_w": b["f_w"] * mesh.size})

            loss_fn = data_parallel(local_loss, mesh, ("X_f", "f_w"))

    @torch.no_grad()
    def predict_u(p, X):
        return mlp.apply(p, X, lb, ub)

    residual_f = residual_fn(lb, ub, nu, dtype)
    holder = {"rar_draws": 0}  # + the live Trainer, whose params RAR scores

    def rar_draw(params, rng):
        # Residual-based adaptive refinement: a candidate pool, the half
        # of N_f with the largest |f| under `params`, the rest uniform
        # from the others (pure top-k collapses onto the shock line).
        M = int(hp["rar_pool"])
        cand = data.lb + (data.ub - data.lb) * lhs(2, M, rng)
        f = np.abs(to_numpy(residual_f(params, tensor(cand))))[:, 0]
        k = hp["N_f"] // 2
        top = np.argsort(-f)[:k]
        rest = rng.choice(np.setdiff1d(np.arange(M), top), hp["N_f"] - k,
                          replace=False)
        holder["rar_draws"] += 1
        return cand[np.concatenate([top, rest])]

    def resample_fn(i):
        # Fresh collocation draw (new stream); data points stay fixed.
        rng = np.random.RandomState(seed + i)
        b = dict(batch)
        if hp.get("rar_pool"):
            X_new = rar_draw(holder["trainer"].params, rng)
        else:
            X_new = data.lb + (data.ub - data.lb) * lhs(2, hp["N_f"], rng)
        if pad:
            b["X_f"], b["f_w"] = padded(X_new)
        else:   # unsharded, or fused DP (N_f a multiple of D)
            b["X_f"] = tensor(X_new)
        return b

    if hp.get("rar_init") and hp.get("rar_pool") and mesh is None:
        # One RAR draw from the starting net (a warm-started stage).
        batch["X_f"] = tensor(rar_draw(net, np.random.RandomState(seed + 999)))

    val_fn = None
    if hp.get("nt_val_every"):
        # Label-free held-out validation: the training loss with the
        # residual on an independent LHS draw the optimizer never sees.
        rng_v = np.random.RandomState(seed + 424242)
        X_f_val = tensor(data.lb + (data.ub - data.lb) * lhs(2, hp["N_f"], rng_v))

        @torch.no_grad()
        def val_fn(p):
            return float(burgers.loss_cont_inference(p, X_u, u, X_f_val,
                                                     lb, ub, nu))

    logger = Logger(hp, device=device)
    trainer = Trainer(loss_fn, net, batch, hp, logger,
                      resample_fn=resample_fn, val_fn=val_fn,
                      adam_loss_fn=adam_loss_fn, mesh=mesh)
    holder["trainer"] = trainer

    def error():
        u_pred = to_numpy(predict_u(trainer.params, X_star))
        return float(np.linalg.norm(data.u_star - u_pred, 2)
                     / np.linalg.norm(data.u_star, 2))

    logger.set_error_fn(error)
    params = trainer.fit()
    maybe_save_params(hp, params)

    with torch.no_grad():  # on the fused path: the loss-only kernel
        loss = float(loss_fn(params, batch))
    u_pred = to_numpy(predict_u(params, X_star))
    if plot:
        from pinn_torch.experiments.viz import plot_inf_cont_results
        plot_inf_cont_results(data.X_star, u_pred, data.X_u_train,
                              data.u_train, data.Exact_u, data.X, data.T,
                              data.x, data.t,
                              save_path=save_path or "experiments",
                              save_hp=hp)
    f_pred = to_numpy(residual_f(params, X_f))
    return {"params": params, "u_pred": u_pred, "f_pred": f_pred,
            "error": error(), "loss": loss, "data": data, "hp": hp,
            "loss_fn": loss_fn, "batch": batch, "predict_u": predict_u,
            "timing": dict(trainer.timing), "rar_draws": holder["rar_draws"]}


if __name__ == "__main__":
    hp, plot = command_line(sys.argv, DEFAULT_HP)
    result = run(hp, plot=plot)
    print(f"rel-L2 error: {result['error']:.4e}")
