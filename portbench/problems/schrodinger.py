"""Continuous-time nonlinear Schrödinger inference
(``reference/schrodinger.py`` states the loss).  Inputs: ``N_0``
positions of the data grid at t = 0, drawn without replacement, with
(u, v) there; ``N_b`` boundary times of the grid, drawn the same way,
at x = lb and x = ub; ``N_f`` Latin-hypercube collocation points of
the configuration's box.  The program's loss is
``pinn_torch.ops.fused_schrodinger.make_schrodinger_loss``: the fused
kernel on the residual term, the initial and boundary terms eager."""

from __future__ import annotations

import numpy as np
import torch

from portbench.generate import collocation, dataset, stream_seed


def make(cfg: dict, n_f: int, seed: int, device):
    d = dataset(cfg["dataset"])
    x, t, uu = d["x"].ravel(), d["tt"].ravel(), d["uu"]   # uu (N_x, N_t)
    lb = np.array(cfg["lb"], np.float32)
    ub = np.array(cfg["ub"], np.float32)
    rng = np.random.default_rng(stream_seed(seed, "data"))
    ix = rng.choice(len(x), int(cfg["N_0"]), replace=False)
    it = rng.choice(len(t), int(cfg["N_b"]), replace=False)
    x0, tb = x[ix], t[it]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    batch = {"X0": f32(np.stack([x0, np.zeros_like(x0)], 1)),
             "H0": f32(np.stack([uu[ix, 0].real, uu[ix, 0].imag], 1)),
             "X_lb": f32(np.stack([np.full_like(tb, lb[0]), tb], 1)),
             "X_ub": f32(np.stack([np.full_like(tb, ub[0]), tb], 1)),
             "X_f": collocation(lb, ub, n_f, seed, 0, device)}
    return batch, {"lb": lb, "ub": ub}


def program_loss(cfg: dict, const: dict):
    from pinn_torch.ops.fused_schrodinger import make_schrodinger_loss
    return make_schrodinger_loss(const["lb"], const["ub"])
