"""``checkpoint.resume_meta`` on the port: the Trainer's periodic
``save_every`` checkpoints, read back without the weights and
warm-resumed (tests/test_train_extras.py's case on the port), and the
port's and the JAX package's ``resume_meta`` agree on a file written by
each."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.models import mlp as jax_mlp
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch.models import mlp
from pinn_torch.train import Trainer
from pinn_torch.utils import checkpoint
from pinn_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(1)


def _quad_setup():
    """Tiny least-squares problem: fit an MLP to u = sin(pi x)."""
    params = mlp.init_mlp([1, 8, 1], torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    lb, ub = torch.tensor([-1.0]), torch.tensor([1.0])
    X = torch.linspace(-1, 1, 32).reshape(-1, 1)
    u = torch.sin(np.pi * X)

    def loss_fn(p, b):
        return torch.mean((mlp.apply(p, b["X"], lb, ub) - b["u"]) ** 2)

    return params, {"X": X, "u": u}, loss_fn


def test_save_every_periodic_checkpoint_and_resume(tmp_path):
    params, batch, loss_fn = _quad_setup()
    ck = str(tmp_path / "periodic.npz")
    hp = {"tf_epochs": 8, "nt_epochs": 12, "tf_lr": 0.01,
          "save_every": 5, "save_checkpoint": ck,
          "nt_line_search": "wolfe", "log_frequency": 100}
    Trainer(loss_fn, params, batch, hp).fit()
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp.npz")
    meta = checkpoint.resume_meta(ck)
    # Adam saves at 5; L-BFGS at 5 and 10 (global 13/18) unless it
    # stopped early on this tiny problem.
    assert meta["phase"] in ("adam", "lbfgs")
    assert meta["phase_epoch"] % 5 == 0 and meta["phase_epoch"] > 0
    if meta["phase"] == "lbfgs":
        assert meta["epoch"] == 8 + meta["phase_epoch"]
    loaded, _ = checkpoint.load_npz(ck, like=params)
    with torch.no_grad():
        f_ck = float(loss_fn(loaded, batch))
        assert np.isfinite(f_ck) and f_ck < float(loss_fn(params, batch))
    # Warm-resume from the periodic save: training continues down.
    p2 = Trainer(loss_fn, loaded, batch,
                 {"tf_epochs": 0, "nt_epochs": 10,
                  "nt_line_search": "wolfe", "log_frequency": 100}).fit()
    with torch.no_grad():
        assert float(loss_fn(p2, batch)) <= f_ck


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("extra", [None, {"phase": "lbfgs", "epoch": 13,
                                          "phase_epoch": 5}])
def test_resume_meta_matches_jax(tmp_path, writer, extra):
    path = str(tmp_path / "ck.npz")
    net = jax_mlp.init_mlp(jax.random.PRNGKey(1), [2, 6, 1], jnp.float64)
    if writer == "jax":
        jax_checkpoint.save_npz_atomic(path, net, hp={"N_u": 3}, extra=extra)
    else:
        pairs = [(np.asarray(w), np.asarray(b)) for w, b in net]
        checkpoint.save_npz_atomic(
            path, params_from_numpy(pairs, "cpu", torch.float64),
            hp={"N_u": 3}, extra=extra)
    got = checkpoint.resume_meta(path)
    assert got == jax_checkpoint.resume_meta(path) == (extra or {})
