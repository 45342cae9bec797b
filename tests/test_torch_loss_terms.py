"""``print_loss_terms`` on the port's Schrödinger experiment against the
JAX one: a line ``mse_0 …    mse_b …    mse_f    …`` at every loss
evaluation, each side's stdout captured and parsed."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.models import mlp as jax_mlp
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch.experiments import inf_cont_schrodinger as torch_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

HP = {"N_0": 30, "N_b": 30, "N_f": 600, "layers": [2, 40, 40, 2],
      "log_frequency": 5}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("loss_terms") / "init.npz")
    jax_checkpoint.save_npz(path, jax_mlp.init_mlp(jax.random.PRNGKey(3),
                                                   HP["layers"], jnp.float64))
    return path


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import inf_cont_schrodinger
    return inf_cont_schrodinger


def _term_lines(text):
    """The (mse_0, mse_b, mse_f) of each ``print_loss_terms`` line."""
    rows = []
    for line in text.splitlines():
        if line.startswith("mse_0 "):
            f = line.split()
            assert (f[0], f[2], f[4]) == ("mse_0", "mse_b", "mse_f"), line
            rows.append([float(f[1]), float(f[3]), float(f[5])])
    return np.array(rows)


@pytest.mark.parametrize("extra", [
    {"dtype": "float64"},
    {"fused_residual": True, "tf_net_dtype": "bfloat16", "N_f": 1030},
])
def test_print_loss_terms_matches_jax(ckpt, jax_exp, capfd, extra):
    """``print_loss_terms``: one line of the three terms at every loss
    evaluation, the Adam phase's included (the bf16 warmup's Adam-phase
    loss too), over 2 Adam steps and one L-BFGS iteration.  In float64
    the values agree to rtol 1e-9, and both runs evaluate the loss as
    many times (the L-BFGS start, then the line search's trials).  The
    bf16 warmup (two 512-point tiles for the JAX kernel's CPU run) is
    held to its own bars: a line count equal to JAX's and the terms to
    rtol 1e-2."""
    hp = {**HP, **extra, "tf_epochs": 2, "nt_epochs": 1,
          "print_loss_terms": True, "init_checkpoint": ckpt}
    jax_exp.run(dict(hp))
    want = _term_lines(capfd.readouterr().out)
    got_r = torch_exp.run({**hp, "device": "cpu"})
    got = _term_lines(capfd.readouterr().out)
    assert got.shape == want.shape and got.shape[0] >= 4
    rtol = 1e-9 if extra.get("dtype") == "float64" else 1e-2
    np.testing.assert_allclose(got, want, rtol=rtol)
    # The closing loss is evaluated unwrapped: no line of its own.
    assert np.isfinite(got_r["loss"])
