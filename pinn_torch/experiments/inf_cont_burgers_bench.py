"""PINN against plain networks on continuous Burgers inference: the
error against the data size.

Counterpart of ``experiments/inf_cont_burgers_bench.py`` (the
reference's notion of a benchmark, an accuracy comparison, not a
timing harness): train the PINN once on N_u initial/boundary points
and N_f collocation points, then plain data-MSE networks of the same
architecture on N_u points drawn over the whole domain
(``NU_DOMAIN``) or from the initial/boundary set only
(``NU_BOUNDARY``), each timed on the host clock after a device
synchronisation.  :func:`measure` does the training and timing and
needs no matplotlib; :func:`draw` makes the figures (the rel-L2
curves against N_u with the PINN's line, and the two training sets in
3D) under ``experiments/results/``.

Usage: ``python -m pinn_torch.experiments.inf_cont_burgers_bench
[--quick] [--device D]``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pinn_torch.data import burgers_cont_identification, burgers_cont_inference
from pinn_torch.device import resolve_device
from pinn_torch.experiments import inf_cont_burgers
from pinn_torch.experiments._common import resolve_dtype
from pinn_torch.models import mlp
from pinn_torch.train import Trainer

# Data sizes the reference scans (its inf_cont_burgers_bench.py:54-89).
NU_DOMAIN = [50, 200, 400, 1000, 2000]
NU_BOUNDARY = [50, 100, 200]
NU_DOMAIN_QUICK = [50, 200, 400]
NU_BOUNDARY_QUICK = [50, 100]
# --quick: the PINN's schedule and the plain networks' Adam steps.
QUICK_PINN_HP = {"tf_epochs": 50, "nt_epochs": 100}
QUICK_NN_EPOCHS = 200


def _now(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def train_plain_nn(N_u: int, boundary_only: bool, hp, dtype, device=None):
    """A plain MSE regression net, the PINN's architecture without the
    residual, on ``N_u`` points (from the initial/boundary set when
    ``boundary_only``); returns (rel-L2 on the grid, seconds)."""
    dev = resolve_device(device)
    np.random.seed(1234)
    if boundary_only:
        d = burgers_cont_inference(N_u, N_f=10)
    else:
        d = burgers_cont_identification(N_u)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    lb, ub = tensor(d.lb), tensor(d.ub)
    batch = {"X_u": tensor(d.X_u_train), "u": tensor(d.u_train)}
    net = mlp.init_mlp(hp["layers"], torch.Generator().manual_seed(1234),
                       dtype, dev)

    def loss_fn(p, b):
        u_pred = mlp.apply(p, b["X_u"], lb, ub)
        return torch.mean(torch.square(b["u"] - u_pred))

    t0 = _now(dev)
    params = Trainer(loss_fn, net, batch, hp, logger=None).fit()
    dur = _now(dev) - t0

    with torch.no_grad():
        u_pred = mlp.apply(params, tensor(d.X_star), lb, ub).cpu().numpy()
    err = float(np.linalg.norm(d.u_star - u_pred, 2)
                / np.linalg.norm(d.u_star, 2))
    return err, dur


def measure(quick: bool = False, device=None) -> dict:
    """Train and time the PINN and every plain network; no figure."""
    dev = resolve_device(device)
    hp_pinn = {**inf_cont_burgers.DEFAULT_HP, "device": str(dev)}
    if quick:
        hp_pinn.update(QUICK_PINN_HP)
    else:
        # Convergence-grade schedule (mixed precision): the reference's
        # default 100 + 200 epochs stops at ~0.36 rel-L2.
        hp_pinn.update(tf_epochs=1000, nt_epochs=5000,
                       nt_vector_dtype="float64", log_frequency=10**6)
    dtype = resolve_dtype(hp_pinn)

    t0 = _now(dev)
    pinn_err = inf_cont_burgers.run(hp_pinn)["error"]
    pinn_time = _now(dev) - t0
    print(f"PINN: rel-L2 {pinn_err:.4e} in {pinn_time:.1f}s "
          f"(N_u={hp_pinn['N_u']} boundary pts + {hp_pinn['N_f']} "
          f"collocation)")

    hp_nn = {**hp_pinn, "nt_epochs": 0,
             "tf_epochs": QUICK_NN_EPOCHS if quick else 1000, "tf_lr": 1e-3}
    res = {"pinn_error": pinn_err, "pinn_seconds": pinn_time,
           "N_u": hp_pinn["N_u"], "quick": quick}
    for key, sizes, boundary in (
            ("domain", NU_DOMAIN_QUICK if quick else NU_DOMAIN, False),
            ("boundary", NU_BOUNDARY_QUICK if quick else NU_BOUNDARY, True)):
        runs = [train_plain_nn(n, boundary, hp_nn, dtype, dev) for n in sizes]
        for n, (e, dur) in zip(sizes, runs):
            print(f"NN ({key} data) N_u={n:5d}: rel-L2 {e:.4e} in {dur:.1f}s")
        res[key] = {"N_u": list(sizes), "errors": [e for e, _ in runs],
                    "seconds": [s for _, s in runs]}
    return res


def draw(res: dict, save_path: str = "experiments") -> None:
    """The figures of :func:`measure`'s result (needs matplotlib)."""
    from pinn_torch.utils.plotting import newfig, pyplot, save_result_dir

    dom, bnd = res["domain"], res["boundary"]
    fig, ax = newfig(1.2)
    ax.loglog(dom["N_u"], dom["errors"], "o-", label="NN, domain data")
    ax.loglog(bnd["N_u"], bnd["errors"], "s-", label="NN, boundary data only")
    ax.axhline(res["pinn_error"], color="r", linestyle="--",
               label=f"PINN ({res['N_u']} bnd pts, {res['pinn_seconds']:.0f}s)")
    for n, e, dur in zip(dom["N_u"], dom["errors"], dom["seconds"]):
        ax.annotate(f"{dur:.0f}s", (n, e), fontsize=7,
                    textcoords="offset points", xytext=(4, 4))
    ax.set_xlabel("$N_u$ (training data size)")
    ax.set_ylabel("rel-$L_2$ error")
    ax.legend(frameon=False, fontsize=8)
    ax.set_title("Burgers: PINN vs plain NN", fontsize=10)
    save_result_dir(save_path, {"bench": "inf_cont_burgers",
                                "quick": res["quick"]})

    # The two training sets in 3D (reference
    # inf_cont_burgers_bench.py:111-136): the domain-sampled NN set and
    # the initial/boundary + collocation PINN set.
    plt = pyplot()
    np.random.seed(1234)
    d_dom = burgers_cont_identification(2000)
    np.random.seed(1234)
    d_bnd = burgers_cont_inference(100, 1000)
    for d, name in ((d_dom, "burgers_data_domain"),
                    (d_bnd, "burgers_data_inibnd")):
        fig = plt.figure(figsize=(5, 4))
        ax3 = fig.add_subplot(projection="3d")
        ax3.scatter(d.X_u_train[:, 0], d.X_u_train[:, 1],
                    d.u_train.ravel(), s=4)
        ax3.set_xlabel("x")
        ax3.set_ylabel("t")
        ax3.set_zlabel("u(x, t)")
        save_result_dir(save_path, {"bench": name})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    draw(measure(args.quick, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
