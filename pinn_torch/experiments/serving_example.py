"""Serving example on the PyTorch port: train an ensemble, export one
serving artifact, serve label-free-robust predictions.

Counterpart of ``experiments/serving_example.py``, with the same
``DEFAULT_HP`` and ``run(hp) -> {"error", "member_errors", "artifact",
"weights"}`` contract:

1. train K members of the continuous-Burgers PINN
   (``pinn_torch.experiments.inf_cont_burgers.run``) from different
   ``init_seed`` values on the same training data;
2. score each by its held-out validation residual (mean squared
   residual on 20,000 fresh LHS points, plus the data misfit; never
   test labels) through ``_common.residual_fn`` — in float32 the
   residual-evaluation kernel — and combine them with
   :class:`pinn_torch.ensemble.EnsemblePINN`, weighted 1/val;
3. export the weighted average as one batch-polymorphic artifact
   (:mod:`pinn_torch.export`, ``.pt2``) for the run's device, member
   and combination weights baked in;
4. reload it, check that it reproduces the in-process ensemble, and
   report its rel-L2 error against the exact solution.

Usage: ``python -m pinn_torch.experiments.serving_example [hp.json]``
(hp extras: ``members`` = ensemble size, ``artifact`` = output path;
the other keys go to each member's run, ``device`` included).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from pinn_torch import export as pexport
from pinn_torch.data import lhs
from pinn_torch.ensemble import EnsemblePINN, inverse_metric_weights, rel_l2
from pinn_torch.experiments import inf_cont_burgers as exp
from pinn_torch.experiments._common import residual_fn
from pinn_torch.models import mlp
from pinn_torch.params import tree_map
from pinn_torch.utils import load_hp

DEFAULT_HP = {
    "N_u": 100,
    "N_f": 10000,
    "layers": [2, 20, 20, 20, 20, 20, 20, 20, 20, 1],
    "tf_epochs": 500,
    "tf_lr": 0.005,
    "tf_b1": 0.9,
    "tf_eps": None,
    "nt_epochs": 1000,
    "nt_lr": 0.8,
    "nt_ncorr": 50,
    "nt_line_search": "wolfe",
    "log_frequency": 500,
    "members": 3,
    "artifact": None,   # default: a temp file
}


def run(hp=None):
    hp = {**DEFAULT_HP, **(hp or {})}
    if hp.get("dtype") == "bfloat16":
        # The JAX example fails its own served-vs-in-process check in
        # bfloat16; the port refuses the run instead.
        raise ValueError("serving_example runs in float32 or float64: in "
                         "bfloat16 the served artifact does not reproduce "
                         "the in-process ensemble")
    members_n = int(hp.pop("members"))
    artifact = hp.pop("artifact")
    seed = hp.get("seed", 1234)

    # 1. Members: same data seed, init from seed + 7919 * j.
    results = []
    for j in range(members_n):
        r = exp.run({**hp, "init_seed": seed + 7919 * j})
        results.append(r)
        print(f"member {j}: rel-L2 {r['error']:.4e}", flush=True)

    data = results[0]["data"]
    X_u = results[0]["batch"]["X_u"]
    dtype, device = X_u.dtype, X_u.device

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    lb, ub = tensor(data.lb), tensor(data.ub)
    residual = residual_fn(lb, ub, 0.01 / np.pi, dtype)

    # 2. Held-out validation residual per member (fresh LHS draw, no
    # test labels) and inverse-metric combination weights.
    rng = np.random.RandomState(97531)
    X_val = tensor(data.lb + (data.ub - data.lb) * lhs(2, 20000, rng))
    u_train = tensor(data.u_train)
    vals = []
    for r in results:
        f = residual(r["params"], X_val)
        u_fit = r["predict_u"](r["params"], X_u)
        vals.append(float(torch.mean(torch.square(f)))
                    + float(torch.mean(torch.square(u_train - u_fit))))
    weights = inverse_metric_weights(vals)

    class _Member:
        def __init__(self, r):
            self.r = r

        def predict(self, X):
            return self.r["predict_u"](self.r["params"], tensor(X))

    ens = EnsemblePINN([_Member(r) for r in results], weights=weights)
    u_ens = ens.predict(data.X_star)
    err_ens = rel_l2(data.u_star, u_ens)
    print(f"ensemble ({members_n} members, 1/val weights): "
          f"rel-L2 {err_ens:.4e}", flush=True)

    # 3. The weighted average as one artifact: a traceable closure over
    # every member's parameters.
    member_params = [tree_map(lambda a: a.detach().clone(), r["params"])
                     for r in results]   # owned copies, not views
    w = [float(wi) for wi in weights]

    def serve_fn(X):
        preds = [mlp.apply(p, X, lb, ub) for p in member_params]
        return sum(wi * pi for wi, pi in zip(w, preds))

    exported = pexport.export_fn(serve_fn, n_features=2, dtype=dtype,
                                 device=device)
    if artifact is None:
        fd, artifact = tempfile.mkstemp(suffix=pexport.SUFFIX)
        os.close(fd)
    path = pexport.save(artifact, exported)
    print(f"artifact: {path} ({os.path.getsize(path)} bytes, "
          f"device {device})", flush=True)

    # 4. Reload and serve: the in-process ensemble on the full grid, and
    # any batch size.
    served = pexport.load(path)
    u_served = served.predict(data.X_star).cpu().numpy()
    err_served = rel_l2(data.u_star, u_served)
    assert np.allclose(u_served, u_ens, rtol=1e-5, atol=1e-6), \
        "served artifact deviates from the in-process ensemble"
    small = served.predict(data.X_star[:3])
    assert tuple(small.shape) == (3, 1)
    print(f"served artifact: rel-L2 {err_served:.4e} "
          f"(members: {[round(r['error'], 6) for r in results]})",
          flush=True)
    return {"error": err_served, "member_errors":
            [r["error"] for r in results], "artifact": path,
            "weights": np.asarray(weights), "vals": vals,
            "bytes": os.path.getsize(path)}


if __name__ == "__main__":
    result = run(load_hp(sys.argv, DEFAULT_HP))
    print(f"rel-L2 error (served ensemble): {result['error']:.4e}")
