"""The PINN-against-plain-network comparisons on the port
(``inf_cont_burgers_bench``, ``ide_cont_burgers_bench``) against the
JAX ones: ``train_plain_nn`` and ``train_plain_nn_surface`` from one
JAX-made init in float64 (the data, the loss and its Adam steps show in
the result to rtol 1e-9), ``fd_identify`` on one grid, and ``--quick``,
its sizes cut further, writing its figures."""

import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.models import mlp as jax_mlp
from pinn_torch.experiments import ide_cont_burgers_bench as torch_ide
from pinn_torch.experiments import inf_cont_burgers_bench as torch_inf
from pinn_torch.models import mlp
from pinn_torch.utils.checkpoint import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

LAYERS = [2, 10, 10, 1]
HP = {"layers": LAYERS, "tf_epochs": 5, "nt_epochs": 0, "tf_lr": 1e-3,
      "tf_b1": 0.9, "tf_eps": None, "log_frequency": 10 ** 6}


@pytest.fixture(scope="module")
def jax_benches():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import ide_cont_burgers_bench
    import inf_cont_burgers_bench
    return inf_cont_burgers_bench, ide_cont_burgers_bench


@pytest.fixture
def one_init(monkeypatch):
    """Both packages' ``init_mlp`` give one JAX-made float64 net."""
    net = jax_mlp.init_mlp(jax.random.PRNGKey(3), LAYERS, jnp.float64)
    pairs = [(np.asarray(w), np.asarray(b)) for w, b in net]
    monkeypatch.setattr(jax_mlp, "init_mlp", lambda key, layers, dtype: net)
    monkeypatch.setattr(mlp, "init_mlp", lambda layers, gen, dtype, dev:
                        params_from_numpy(pairs, dev, dtype))


@pytest.mark.parametrize("boundary_only", [False, True])
def test_train_plain_nn_matches_jax(jax_benches, one_init, boundary_only):
    want, _ = jax_benches[0].train_plain_nn(60, boundary_only, HP,
                                            jnp.float64)
    got, seconds = torch_inf.train_plain_nn(60, boundary_only, HP,
                                            torch.float64, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert seconds > 0


def test_train_plain_nn_surface_matches_jax(jax_benches, one_init):
    want_U, want_d = jax_benches[1].train_plain_nn_surface(80, HP,
                                                           jnp.float64)
    got_U, got_d = torch_ide.train_plain_nn_surface(80, HP, torch.float64,
                                                    "cpu")
    np.testing.assert_array_equal(got_d.X_u_train, want_d.X_u_train)
    np.testing.assert_allclose(got_U, np.asarray(want_U), rtol=1e-9,
                               atol=1e-12)


def test_fd_identify_matches_jax(jax_benches):
    x = np.linspace(-1.0, 1.0, 41)
    t = np.linspace(0.0, 1.0, 21)
    X, T = np.meshgrid(x, t)
    U = -np.sin(np.pi * X) * np.exp(-T) + 0.1 * X * T
    assert torch_ide.fd_identify(U, x, t) == jax_benches[1].fd_identify(U, x, t)


@pytest.mark.parametrize("bench,cuts,n_figures", [
    (torch_inf, {"QUICK_PINN_HP": {"tf_epochs": 3, "nt_epochs": 3,
                                   "N_f": 200},
                 "NU_DOMAIN_QUICK": [20, 40], "NU_BOUNDARY_QUICK": [20],
                 "QUICK_NN_EPOCHS": 3}, 3),
    (torch_ide, {"QUICK_HP": {"tf_epochs": 3, "nt_epochs": 3, "N_u": 200},
                 "QUICK_NN_EPOCHS": 3}, 1),
], ids=["inf", "ide"])
def test_quick_writes_its_figures(monkeypatch, tmp_path, bench, cuts,
                                  n_figures):
    pytest.importorskip("matplotlib")
    from pinn_torch.utils import plotting
    monkeypatch.setattr(plotting, "_REPO_ROOT", str(tmp_path))
    for name, value in cuts.items():
        monkeypatch.setattr(bench, name, value)
    saved = []
    save = plotting.save_result_dir
    monkeypatch.setattr(plotting, "save_result_dir",
                        lambda *a: saved.append(save(*a)) or saved[-1])
    assert bench.main(["--quick", "--device", "cpu"]) == 0
    # Figures saved within one second share a directory, as in the JAX
    # package's save_result_dir.
    assert len(saved) == n_figures
    dirs = glob.glob(str(tmp_path / "experiments" / "results" / "*"))
    assert sorted(set(saved)) == sorted(dirs)
    for d in dirs:
        assert all(os.path.getsize(os.path.join(d, f)) > 0
                   for f in ("graph.pdf", "graph.png", "hp.json"))
