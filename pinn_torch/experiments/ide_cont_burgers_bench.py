"""Burgers identification: the PINN against a plain network with
finite differences.

Counterpart of ``experiments/ide_cont_burgers_bench.py``: train the
identification PINN (clean case), train a plain network of the same
architecture on the same kind of data, and recover (lambda1, lambda2)
from that network's surface on the grid by numpy finite differences
and linear least squares (:func:`fd_identify`).  :func:`measure` does
the training and timing (host clock after a device synchronisation)
and needs no matplotlib; :func:`draw` makes the bar chart of both
pairs under ``experiments/results/``.

Usage: ``python -m pinn_torch.experiments.ide_cont_burgers_bench
[--quick] [--device D]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pinn_torch.data import burgers_cont_identification
from pinn_torch.device import resolve_device
from pinn_torch.experiments import ide_cont_burgers
from pinn_torch.experiments._common import setup
from pinn_torch.models import mlp
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger

NU_TRUE = 0.01 / np.pi
# --quick: the PINN's schedule and size, and the plain network's Adam steps.
QUICK_HP = {"tf_epochs": 50, "nt_epochs": 100, "N_u": 500}
QUICK_NN_EPOCHS = 200


def _now(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def train_plain_nn_surface(N_u, hp, dtype, device=None):
    """A plain MSE net on ``N_u`` points over the domain; returns its
    values on the grid, (nt, nx), and the data."""
    dev = resolve_device(device)
    np.random.seed(1234)
    d = burgers_cont_identification(N_u)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    lb, ub = tensor(d.lb), tensor(d.ub)
    batch = {"X_u": tensor(d.X_u_train), "u": tensor(d.u_train)}
    net = mlp.init_mlp(hp["layers"], torch.Generator().manual_seed(1234),
                       dtype, dev)

    def loss_fn(p, b):
        return torch.mean(torch.square(
            b["u"] - mlp.apply(p, b["X_u"], lb, ub)))

    params = Trainer(loss_fn, net, batch, hp, logger=None).fit()
    with torch.no_grad():
        U = mlp.apply(params, tensor(d.X_star), lb, ub).cpu().numpy()
    nt, nx = d.T.shape
    return U.reshape(nt, nx), d


def fd_identify(U_grid, x, t):
    """Least-squares (lambda1, lambda2) from numpy grid derivatives of
    ``U_grid`` (nt, nx): u_t + l1 u u_x - l2 u_xx = 0 on the interior."""
    dx = float(x[1] - x[0])
    dtv = float(t[1] - t[0])
    u_t = np.gradient(U_grid, dtv, axis=0)
    u_x = np.gradient(U_grid, dx, axis=1)
    u_xx = np.gradient(u_x, dx, axis=1)
    interior = np.s_[2:-2, 2:-2]
    A = np.stack([(U_grid * u_x)[interior].ravel(),
                  (-u_xx)[interior].ravel()], axis=1)
    b = -u_t[interior].ravel()
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    return float(sol[0]), float(sol[1])


def _lambda_error(l1, l2):
    return (abs(l1 - 1.0) + abs(l2 - NU_TRUE) / NU_TRUE) / 2


def measure(quick: bool = False, device=None) -> dict:
    """Train and time the PINN and the plain network; no figure."""
    dev = resolve_device(device)
    hp = {**ide_cont_burgers.DEFAULT_HP, "device": str(dev)}
    if quick:
        hp.update(QUICK_HP)
    else:
        hp.update(tf_epochs=1000, nt_epochs=5000,
                  nt_vector_dtype="float64", log_frequency=10**6)
    seed, dtype, _ = setup(hp)

    t0 = _now(dev)
    logger = Logger({**hp, "log_frequency": 10 ** 9}, device=dev)
    params, *_ = ide_cont_burgers.train_once(hp, seed, dtype, dev,
                                             noise=0.0, logger=logger)
    l1_pinn, l2_pinn = ide_cont_burgers.get_lambdas(params)
    pinn_time = _now(dev) - t0
    print(f"PINN identified: l1={l1_pinn:.5f} l2={l2_pinn:.7f} "
          f"(true 1.0, {NU_TRUE:.7f}) in {pinn_time:.1f}s")

    hp_nn = {**hp, "nt_epochs": 0,
             "tf_epochs": QUICK_NN_EPOCHS if quick else 2000, "tf_lr": 1e-3}
    t0 = _now(dev)
    U_grid, d = train_plain_nn_surface(hp["N_u"], hp_nn, dtype, dev)
    l1_fd, l2_fd = fd_identify(U_grid, d.x.ravel(), d.t.ravel())
    fd_time = _now(dev) - t0
    print(f"NN+FD identified: l1={l1_fd:.5f} l2={l2_fd:.7f} in {fd_time:.1f}s")
    res = {"pinn": (l1_pinn, l2_pinn), "fd": (l1_fd, l2_fd),
           "pinn_seconds": pinn_time, "fd_seconds": fd_time,
           "pinn_error": _lambda_error(l1_pinn, l2_pinn),
           "fd_error": _lambda_error(l1_fd, l2_fd), "quick": quick}
    print(f"mean rel lambda error: PINN {res['pinn_error']:.3e}  "
          f"NN+FD {res['fd_error']:.3e}")
    return res


def draw(res: dict, save_path: str = "experiments") -> None:
    """The bar chart of :func:`measure`'s result (needs matplotlib)."""
    from pinn_torch.utils.plotting import newfig, save_result_dir

    (l1_pinn, l2_pinn), (l1_fd, l2_fd) = res["pinn"], res["fd"]
    fig, ax = newfig(1.2)
    labels = ["$\\lambda_1$ (true 1)", "$\\lambda_2/\\nu$ (true 1)"]
    width = 0.35
    xpos = np.arange(2)
    ax.bar(xpos - width / 2, [l1_pinn, l2_pinn / NU_TRUE], width,
           label=f"PINN ({res['pinn_seconds']:.0f}s)")
    ax.bar(xpos + width / 2, [l1_fd, l2_fd / NU_TRUE], width,
           label=f"NN + finite differences ({res['fd_seconds']:.0f}s)")
    ax.axhline(1.0, color="k", linewidth=0.8, linestyle=":")
    ax.set_xticks(xpos)
    ax.set_xticklabels(labels)
    ax.legend(frameon=False, fontsize=8)
    ax.set_title("Burgers identification: PINN vs NN+FD", fontsize=10)
    save_result_dir(save_path, {"bench": "ide_cont_burgers",
                                "quick": res["quick"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    draw(measure(args.quick, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
