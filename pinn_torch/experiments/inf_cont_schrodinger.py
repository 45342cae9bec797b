"""Continuous-time 1D nonlinear Schrödinger inference on the PyTorch port.

Counterpart of ``experiments/inf_cont_schrodinger.py``, with the same
``DEFAULT_HP`` and ``run(hp) -> {"params", "error", "u_pred", ...}``
contract: a [2, 100x4, 2] tanh MLP for (u, v) = (Re h, Im h), N_0 = 50
initial points, N_b = 50 boundary times (periodic BCs on value and
x-derivative), N_f = 20,000 LHS collocation points, Adam (lr 0.05,
beta1 0.99, eps 0.1) then optional L-BFGS, error = rel-L2 of |h| on the
grid.  Each log line carries the three loss terms.

- ``fused_residual: True`` puts the residual term on the fused loss
  (``pinn_torch.ops.fused_schrodinger.make_schrodinger_loss``): the
  CUDA kernels on a CUDA device, their plain version on the CPU; the
  IC/BC terms stay eager.  float32 only.  ``fused_residual: "bf16"``
  takes the bf16-stream kernels in both phases.
- ``tf_net_dtype: "bfloat16"``: on the fused path the Adam phase takes
  the bf16-stream kernels, L-BFGS the f32 ones, and the key leaves hp
  before it is logged (as in the JAX experiment); on the eager path
  the Trainer casts the Adam phase's loss.
- ``dtype: "float64"`` trains on the eager loss; ``net_impl: "df32"``
  runs as native float64.
- ``nt_resample``/``tf_resample`` draw fresh collocation points;
  ``nt_val_every`` selects the best L-BFGS iterate on a held-out draw.
- ``print_loss_terms: true`` prints ``mse_0 …    mse_b …    mse_f    …``
  on every evaluation of the loss, the Adam phase's too, as the
  reference's ``tf.print`` and the JAX experiment's ``jax.debug.print``
  do: a debug mode, with a host sync per evaluation.
- ``tpu_mesh`` splits the collocation axis over a
  ``pinn_torch.parallel`` mesh of D shards, as in ``inf_cont_burgers``:
  with ``fused_residual`` one residual kernel launch a shard on N_f/D
  rows (``make_schrodinger_loss_dp``), else X_f padded with zero
  weights (``f_w``) and the eager loss a shard, weights ×D; the IC/BC
  terms on every shard.
- ``plot=True`` draws ``plot_schrodinger_results``
  (``pinn_torch.experiments.viz``; needs matplotlib).

Usage: ``python -m pinn_torch.experiments.inf_cont_schrodinger [hp.json]
[--plot]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pinn_torch.data import lhs, schrodinger_inference
from pinn_torch.dtypes import to_numpy
from pinn_torch.experiments._common import (command_line, maybe_load_params,
                                            maybe_save_params, resolve_mesh,
                                            setup, wants_bf16)
from pinn_torch.models import mlp
from pinn_torch.problems import schrodinger
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger

DEFAULT_HP = {
    "N_0": 50,
    "N_b": 50,
    "N_f": 20000,
    "layers": [2, 100, 100, 100, 100, 2],
    "tf_epochs": 200,
    "tf_lr": 0.05,
    "tf_b1": 0.99,
    "tf_eps": 1e-1,
    "nt_epochs": 0,
    "nt_lr": 1.2,
    "nt_ncorr": 50,
    "nt_line_search": "armijo",
    "log_frequency": 10,
}


def run(hp=None, plot=False, save_path=None):
    hp = {**DEFAULT_HP, **(hp or {})}
    seed, dtype, device = setup(hp)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def padded(X):
        from pinn_torch.parallel import pad_points_with_weights
        Xp, w = pad_points_with_weights(np.asarray(X), mesh.size)
        return tensor(Xp), tensor(w)

    data = schrodinger_inference(hp["N_0"], hp["N_b"], hp["N_f"])
    lb, ub = tensor(data.lb), tensor(data.ub)

    # Point sets (reference inf_cont_schrodinger.py:49-56).
    X0 = np.concatenate([data.x0, 0 * data.x0], axis=1)
    H0 = np.hstack([data.u0, data.v0])
    X_lb = np.concatenate([0 * data.tb + data.lb[0], data.tb], axis=1)
    X_ub = np.concatenate([0 * data.tb + data.ub[0], data.tb], axis=1)
    batch = {"X0": tensor(X0), "H0": tensor(H0), "X_lb": tensor(X_lb),
             "X_ub": tensor(X_ub), "X_f": tensor(data.X_f)}
    X_star = tensor(data.X_star)
    mesh = resolve_mesh(hp, device)
    pad = mesh is not None and not hp.get("fused_residual")
    if pad:
        # Eager mesh path: zero-weight pad rows so any N_f divides the
        # mesh (the fused DP path requires N_f % D == 0 instead).
        batch["X_f"], batch["f_w"] = padded(data.X_f)

    gen = torch.Generator().manual_seed(int(hp.get("init_seed") or seed))
    net = maybe_load_params(hp, mlp.init_mlp(hp["layers"], gen, dtype, device))

    adam_loss_fn = None  # the Adam phase's loss, when it differs
    if hp.get("fused_residual"):
        if dtype != torch.float32:
            raise ValueError("fused_residual requires dtype=float32 "
                             "(the eager loss covers float64)")
        from pinn_torch.ops.fused_schrodinger import (
            make_schrodinger_loss, make_schrodinger_loss_dp)

        def build_fused(stream):
            if mesh is not None:
                return make_schrodinger_loss_dp(data.lb, data.ub, mesh,
                                                stream_dtype=stream)
            return make_schrodinger_loss(data.lb, data.ub, stream_dtype=stream)

        loss_fn = build_fused("bfloat16" if wants_bf16(hp["fused_residual"])
                              else None)
        if wants_bf16(hp.get("tf_net_dtype")):
            # bf16 warmup on the fused path: Adam on the bf16-stream
            # residual kernels, L-BFGS on loss_fn; the key is not logged.
            adam_loss_fn = build_fused("bfloat16")
            hp = {k: v for k, v in hp.items() if k != "tf_net_dtype"}
    else:
        def loss_fn(p, b):
            return schrodinger.loss(p, b["X0"], b["H0"], b["X_lb"],
                                    b["X_ub"], b["X_f"], lb, ub,
                                    f_weights=b.get("f_w"))

        if mesh is not None:
            from pinn_torch.parallel import data_parallel
            eager = loss_fn

            def local_loss(p, b):   # a shard's rows, its weights x D
                return eager(p, {**b, "f_w": b["f_w"] * mesh.size})

            loss_fn = data_parallel(local_loss, mesh, ("X_f", "f_w"))

    final_loss_fn = loss_fn   # the final loss, printed by no wrapper
    if hp.get("print_loss_terms"):
        def _print_wrap(base):
            def wrapped(p, b):
                with torch.no_grad():
                    t = schrodinger.loss_terms(p, b["X0"], b["H0"], b["X_lb"],
                                               b["X_ub"], b["X_f"], lb, ub,
                                               b.get("f_w"))
                print(f"mse_0 {float(t.mse_0)}    mse_b {float(t.mse_b)}    "
                      f"mse_f    {float(t.mse_f)}")
                return base(p, b)
            return wrapped

        loss_fn = _print_wrap(loss_fn)
        if adam_loss_fn is not None:
            # The bf16 warmup's Adam-phase loss prints too.
            adam_loss_fn = _print_wrap(adam_loss_fn)

    def epoch_extra(p):
        # The reference prints the three loss terms each step; here
        # once per log line, from the eager terms.
        with torch.no_grad():
            t = schrodinger.loss_terms(p, batch["X0"], batch["H0"],
                                       batch["X_lb"], batch["X_ub"],
                                       batch["X_f"], lb, ub, batch.get("f_w"))
        return (f"mse_0 = {float(t.mse_0):.4e}  "
                f"mse_b = {float(t.mse_b):.4e}  "
                f"mse_f = {float(t.mse_f):.4e}")

    def resample_fn(i):
        # Fresh LHS collocation draw (new stream); IC/BC stacks stay.
        rng = np.random.RandomState(seed + i)
        X_new = data.lb + (data.ub - data.lb) * lhs(2, hp["N_f"], rng)
        b = dict(batch)
        if pad:
            b["X_f"], b["f_w"] = padded(X_new)
        else:   # unsharded, or fused DP (N_f a multiple of D)
            b["X_f"] = tensor(X_new)
        return b

    val_fn = None
    if hp.get("nt_val_every"):
        # Label-free held-out validation: the eager loss with the
        # residual on an independent LHS draw.
        rng_v = np.random.RandomState(seed + 424242)
        X_f_val = tensor(data.lb + (data.ub - data.lb) * lhs(2, hp["N_f"], rng_v))

        @torch.no_grad()
        def val_fn(p):
            return float(schrodinger.loss(p, batch["X0"], batch["H0"],
                                          batch["X_lb"], batch["X_ub"],
                                          X_f_val, lb, ub))

    @torch.no_grad()
    def predict_h(p):
        return to_numpy(mlp.apply(p, X_star, lb, ub))

    logger = Logger(hp, device=device)
    trainer = Trainer(loss_fn, net, batch, hp, logger,
                      epoch_extra=epoch_extra, resample_fn=resample_fn,
                      val_fn=val_fn, adam_loss_fn=adam_loss_fn, mesh=mesh)

    def error(H=None):
        H = predict_h(trainer.params) if H is None else H
        h_pred = np.sqrt(H[:, 0:1] ** 2 + H[:, 1:2] ** 2)
        return float(np.linalg.norm(data.h_star - h_pred, 2)
                     / np.linalg.norm(data.h_star, 2))

    logger.set_error_fn(error)
    params = trainer.fit()
    maybe_save_params(hp, params)

    with torch.no_grad():  # on the fused path: the loss-only kernel
        loss = float(final_loss_fn(params, batch))
    H = predict_h(params)
    u_pred, v_pred = H[:, 0:1], H[:, 1:2]
    h_pred = np.sqrt(u_pred ** 2 + v_pred ** 2)
    if plot:
        from pinn_torch.experiments.viz import plot_schrodinger_results
        plot_schrodinger_results(data.X_star, u_pred, v_pred, h_pred,
                                 data.Exact_h, data.X, data.T, data.x,
                                 data.t, data.lb, data.ub, data.x0, data.tb,
                                 save_path=save_path or "experiments",
                                 save_hp=hp)
    return {"params": params, "u_pred": u_pred, "v_pred": v_pred,
            "h_pred": h_pred, "error": error(H),
            "loss": loss, "data": data, "hp": hp, "loss_fn": loss_fn,
            "batch": batch, "timing": dict(trainer.timing)}


if __name__ == "__main__":
    hp, plot = command_line(sys.argv, DEFAULT_HP)
    result = run(hp, plot=plot)
    print(f"rel-L2 error (|h|): {result['error']:.4e}")
