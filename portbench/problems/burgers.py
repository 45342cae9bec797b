"""Continuous-time Burgers inference (``reference/burgers.py`` states the
loss).  Inputs: ``N_u`` points of the data grid's initial and boundary
set (the t = 0 row and the x = lb and x = ub columns), drawn without
replacement, with u there; ``N_f`` Latin-hypercube collocation points
of the configuration's box.  The program's loss is
``pinn_torch.ops.fused_train.make_burgers_loss``: the data and the
collocation points in one fused kernel stream."""

from __future__ import annotations

import numpy as np
import torch

from portbench.generate import collocation, dataset, stream_seed


def make(cfg: dict, n_f: int, seed: int, device):
    d = dataset(cfg["dataset"])
    x, t, usol = d["x"].ravel(), d["t"].ravel(), d["usol"]   # usol (N_x, N_t)
    lb = np.array(cfg["lb"], np.float32)
    ub = np.array(cfg["ub"], np.float32)
    X_set = np.concatenate([np.stack([x, np.zeros_like(x)], 1),
                            np.stack([np.full_like(t, x[0]), t], 1),
                            np.stack([np.full_like(t, x[-1]), t], 1)])
    u_set = np.concatenate([usol[:, 0], usol[0, :], usol[-1, :]])
    rng = np.random.default_rng(stream_seed(seed, "data"))
    ix = rng.choice(len(X_set), int(cfg["N_u"]), replace=False)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    batch = {"X_u": f32(X_set[ix]), "u": f32(u_set[ix, None]),
             "X_f": collocation(lb, ub, n_f, seed, 0, device)}
    return batch, {"lb": lb, "ub": ub, "nu": float(cfg["nu"])}


def program_loss(cfg: dict, const: dict):
    from pinn_torch.ops.fused_train import make_burgers_loss
    return make_burgers_loss(const["lb"], const["ub"], const["nu"])
