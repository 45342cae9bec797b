"""The port's figures: ``pinn_torch.utils.plotting`` and the six
figure functions of ``pinn_torch.experiments.viz`` on tests/test_viz.py's
synthetic inputs of the real shapes; the arrays three experiments hand
their figure function with ``plot=True`` against the JAX experiments' (float64,
one JAX-saved init, each side's figure function replaced by a recorder); and
real ``plot=True`` runs, through ``python -m pinn_torch run NAME
--plot`` and ``run(plot=True, save_path=...)``, writing ``graph.pdf``,
``graph.png`` and ``hp.json``.  Each drawing test asks for matplotlib
itself, so the file collects where it is missing.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.models import mlp as jax_mlp
from pinn.problems import burgers as jax_burgers
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch.experiments import viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

NX, NT = 24, 130  # t-axis covers the slice indices (25/50/75/100/125)


@pytest.fixture
def plt():
    plt = pytest.importorskip("matplotlib.pyplot")
    yield plt
    plt.close("all")


def _grid():
    x = np.linspace(-1.0, 1.0, NX)[:, None]
    t = np.linspace(0.0, 1.0, NT)[:, None]
    X, T = np.meshgrid(x[:, 0], t[:, 0])          # (NT, NX)
    X_star = np.hstack([X.reshape(-1, 1), T.reshape(-1, 1)])
    Exact_u = np.sin(np.pi * X) * np.exp(-T)      # (NT, NX)
    return x, t, X, T, X_star, Exact_u, Exact_u.reshape(-1, 1)


def _assert_result_dir(res_dir):
    assert os.path.isdir(res_dir)
    for name in ("graph.pdf", "graph.png", "hp.json"):
        path = os.path.join(res_dir, name)
        assert os.path.isfile(path) and os.path.getsize(path) > 0, name


def _inf_cont(path):
    x, t, X, T, X_star, Exact_u, u_pred = _grid()
    return viz.plot_inf_cont_results(
        X_star, u_pred, X_star[:: NX * 10], u_pred[:: NX * 10], Exact_u, X,
        T, x, t, save_path=path, save_hp={"N_u": 13})


def _ide_cont(path):
    x, t, X, T, X_star, Exact_u, u_pred = _grid()
    return viz.plot_ide_cont_results(
        X_star, u_pred, X_star[:: NX * 10], u_pred[:: NX * 10], Exact_u, X,
        T, x, t, 1.0001, 0.999, 0.0032, 0.0031, save_path=path, save_hp={})


def _inf_disc(path):
    x, t, X, T, X_star, Exact_u, u_pred = _grid()
    return viz.plot_inf_disc_results(
        x[:, 0], 10, 90, x[::2], Exact_u[10, ::2][:, None], np.array([1.0]),
        np.array([-1.0]), Exact_u[90, :][:, None], Exact_u, x, t,
        save_path=path, save_hp={})


def _ide_disc(path, **kw):
    x, t, X, T, X_star, Exact_u, u_pred = _grid()
    Exact = Exact_u.T  # (NX, NT)
    return viz.plot_ide_disc_results(
        x[:, 0], t[:, 0], 10, 90, x[::2], Exact[::2, 10][:, None], x[1::2],
        Exact[1::2, 90][:, None], np.array([1.0]), np.array([-1.0]), Exact,
        1.0001, 0.999, 0.0032, 0.0031, save_path=path, save_hp={}, **kw)


def _schrodinger(path):
    x, t, X, T, X_star, Exact_u, u_pred = _grid()
    return viz.plot_schrodinger_results(
        X_star, u_pred, u_pred, (np.abs(Exact_u) + 1.0).reshape(-1, 1),
        np.abs(Exact_u).T + 1.0, X, T, x, t, np.array([-1.0, 0.0]),
        np.array([1.0, 1.0]), x[::3], t[::10], save_path=path, save_hp={})


def _navierstokes(path):
    from pinn_torch.datagen.navierstokes_exact import generate
    d = generate(nx=12, ny=12, nt=3)
    n = d.X_star.shape[0]
    rng = np.random.RandomState(0)
    return viz.plot_ide_navierstokes_results(
        d, d.u_star + 0.01 * rng.randn(n, 1), d.v_star + 0.01 * rng.randn(n, 1),
        d.p_star + 0.01 * rng.randn(n, 1), 1.0001, 0.998, 0.0099, 0.0102,
        save_path=path, save_hp={})


def _plotting_layout(path):
    from pinn_torch.utils import plotting
    w, h = plotting.figsize(1.0, 2.0)
    assert h == pytest.approx(2.0 * w * plotting.GOLDEN_MEAN)
    fig, ax = plotting.newfig(1.0)
    assert tuple(fig.get_size_inches()) == pytest.approx(
        tuple(plotting.figsize(1.0)), rel=1e-6)
    ax.plot([0, 1], [0, 1])
    res_dir = plotting.save_result_dir(path, {"N_u": 7})
    # layout: <save_path>/results/<stamp>-<script>
    assert os.path.dirname(os.path.dirname(res_dir)) == path
    assert os.path.basename(os.path.dirname(res_dir)) == "results"
    with open(os.path.join(res_dir, "hp.json")) as fh:
        assert json.load(fh) == {"N_u": 7}
    return res_dir


@pytest.mark.parametrize("build", [
    _plotting_layout, _inf_cont, _ide_cont, _inf_disc, _ide_disc,
    lambda path: _ide_disc(path, lambda2_star=0.0025, deriv="u_{xxx}"),
    _schrodinger, _navierstokes,
], ids=["plotting", "inf_cont", "ide_cont", "inf_disc", "ide_disc",
        "ide_disc_kdv", "schrodinger", "navierstokes"])
def test_figures_write_the_result_dir(plt, tmp_path, build):
    _assert_result_dir(build(str(tmp_path)))


# ---------------------------------------------------------------------------
# What three experiments hand their figure function, against the JAX ones
# ---------------------------------------------------------------------------

CASES = {
    "inf_cont_burgers": ("plot_inf_cont_results",
                         {"N_u": 30, "N_f": 300, "layers": [2, 12, 12, 1]}),
    "ide_disc_burgers": ("plot_ide_disc_results",
                         {"N_0": 30, "N_1": 30, "layers": [1, 12, 0]}),
    "inf_cont_schrodinger": ("plot_schrodinger_results",
                             {"N_0": 20, "N_b": 20, "N_f": 300,
                              "layers": [2, 16, 16, 2]}),
}


def _init(name, hp, path):
    """JAX-saved float64 inits (a second, ``-noisy``, one for the
    identification case)."""
    layers = list(hp["layers"])
    if name == "ide_disc_burgers":
        layers[-1] = 81  # q from irk.auto_stages(0.8)
        for i, p in enumerate((path, path.replace(".npz", "-noisy.npz"))):
            net = jax_mlp.init_mlp(jax.random.PRNGKey(11 + i), layers,
                                   jnp.float64)
            jax_checkpoint.save_npz(p, jax_burgers.init_ide_params(net))
    else:
        jax_checkpoint.save_npz(path, jax_mlp.init_mlp(
            jax.random.PRNGKey(5), layers, jnp.float64))


def _recorder(calls):
    def record(*args, **kw):
        calls.append((args, kw))
    return record


def _same(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (str, type(None))):
        assert got == want, where
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-9,
                                   atol=1e-12, err_msg=where)


@pytest.mark.parametrize("name", list(CASES))
def test_plot_inputs_match_jax(monkeypatch, tmp_path, name):
    """``plot=True``: the arrays, lambdas, indices and hp each side hands
    its figure function (the port's hp without its ``device``), float64 from one
    JAX-saved init, 5 Adam steps."""
    pytest.importorskip("matplotlib")
    import importlib
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import viz as jax_viz
    jax_exp = importlib.import_module(name)
    torch_exp = importlib.import_module(f"pinn_torch.experiments.{name}")
    figure, sizes = CASES[name]
    ckpt = str(tmp_path / "init.npz")
    _init(name, sizes, ckpt)
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_viz, figure, _recorder(calls["jax"]))
    monkeypatch.setattr(viz, figure, _recorder(calls["port"]))
    hp = {**sizes, "dtype": "float64", "tf_epochs": 5, "nt_epochs": 0,
          "log_frequency": 10 ** 6, "init_checkpoint": ckpt}
    jax_exp.run(dict(hp), plot=True, save_path=str(tmp_path))
    torch_exp.run({**hp, "device": "cpu"}, plot=True,
                  save_path=str(tmp_path))
    (got_args, got_kw), = calls["port"]
    (want_args, want_kw), = calls["jax"]
    assert len(got_args) == len(want_args)
    got_hp, want_hp = got_kw.pop("save_hp"), want_kw.pop("save_hp")
    assert got_hp.pop("device") == "cpu"
    assert got_hp == want_hp
    for i, (g, w) in enumerate(zip(got_args, want_args)):
        _same(g, w, f"{figure} argument {i}")
    _same(got_kw, want_kw, figure)


# ---------------------------------------------------------------------------
# Real figures
# ---------------------------------------------------------------------------

DISC = ["--set", "device=cpu", "--set", "N_n=30", "--set", "q=8",
        "--set", "layers=[1, 12, 9]", "--set", "tf_epochs=3",
        "--set", "nt_epochs=3"]


def test_cli_run_plot_writes_the_figure(plt, monkeypatch, tmp_path, capsys):
    """``python -m pinn_torch run inf_disc_burgers --plot``: the default
    save path, ``experiments`` against the repo root (here a temporary
    root), gets ``results/<stamp>-<script>/``."""
    from pinn_torch import cli
    from pinn_torch.utils import plotting
    monkeypatch.setattr(plotting, "_REPO_ROOT", str(tmp_path))
    assert cli.main(["run", "inf_disc_burgers", "--plot", *DISC]) == 0
    assert "error: " in capsys.readouterr().out
    res_dir, = glob.glob(str(tmp_path / "experiments" / "results" / "*"))
    _assert_result_dir(res_dir)
    with open(os.path.join(res_dir, "hp.json")) as fh:
        assert json.load(fh)["q"] == 8


def test_run_plot_with_save_path(plt, tmp_path):
    from pinn_torch.experiments import ide_disc_kdv
    r = ide_disc_kdv.run({"device": "cpu", "N_0": 30, "N_1": 30, "q": 8,
                          "layers": [1, 12, 0], "tf_epochs": 3,
                          "nt_epochs": 3}, plot=True, save_path=str(tmp_path))
    res_dir, = glob.glob(str(tmp_path / "results" / "*"))
    _assert_result_dir(res_dir)
    assert np.isfinite(r["error"])


def test_cli_plot_refuses_an_experiment_without_a_figure():
    from pinn_torch import cli
    with pytest.raises(SystemExit, match="draws no figure"):
        cli.main(["run", "serving_example", "--plot", "--set", "device=cpu"])
