"""The port's Burgers inference experiment against the JAX package's,
end to end, from one npz checkpoint; and the port's import boundary.

Both runs load the same weights (``init_checkpoint``) and draw the same
data from the same seed (``pinn_torch.data`` keeps the RNG call order),
so in float64 they follow one trajectory: the final loss to rtol 1e-6
and rel-L2 to rtol 1e-5.  The fused float32 path is held to rtol 1e-3,
the bar tests/test_pallas_train.py sets between its fused and XLA runs.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pinn.models import mlp as jax_mlp
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch.experiments import inf_cont_burgers as torch_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

HP = {"N_u": 50, "N_f": 500, "layers": [2, 20, 20, 1], "tf_epochs": 10,
      "nt_epochs": 10, "log_frequency": 5}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX-initialised checkpoint both packages start from."""
    path = str(tmp_path_factory.mktemp("slice") / "init.npz")
    params = jax_mlp.init_mlp(jax.random.PRNGKey(7), HP["layers"],
                              jax.numpy.float64)
    jax_checkpoint.save_npz(path, params)
    return path


@pytest.fixture(scope="module")
def jax_exp():
    """The JAX experiment module, imported when a test needs it (its
    scaffolding initialises the JAX backend on import)."""
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import inf_cont_burgers
    return inf_cont_burgers


def _jax_final_loss(res):
    return float(res["loss_fn"](res["params"], res["batch"]))


def test_float64_run_matches_jax(ckpt, jax_exp):
    hp = {**HP, "dtype": "float64", "init_checkpoint": ckpt}
    want = jax_exp.run(dict(hp))
    got = torch_exp.run({**hp, "device": "cpu"})
    np.testing.assert_allclose(got["loss"], _jax_final_loss(want), rtol=1e-6)
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-5)


def test_fused_float32_run_matches_jax(ckpt, jax_exp):
    hp = {**HP, "fused_residual": True, "init_checkpoint": ckpt}
    want = jax_exp.run(dict(hp))
    got = torch_exp.run({**hp, "device": "cpu"})
    np.testing.assert_allclose(got["loss"], _jax_final_loss(want), rtol=1e-3)
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-3)


def test_fused_bf16_warmup_run_matches_jax(ckpt, jax_exp, tmp_path):
    """The campaign's bf16 warmup, ``fused_residual: True, tf_net_dtype:
    "bfloat16"``: Adam on the bf16-stream kernels (their plain versions
    here), L-BFGS on the float32 ones, and the key gone from the logged
    hp in both packages.  Logged losses rtol 1e-2, rel-L2 rtol 5e-2.
    N_f = 1,000 gives the JAX kernel two 1,024-point tiles: with one,
    XLA's CPU backend refuses the JAX run's bf16 dot."""
    hp = {**HP, "N_f": 1000, "fused_residual": True,
          "tf_net_dtype": "bfloat16", "init_checkpoint": ckpt}
    want = jax_exp.run({**hp, "log_file": str(tmp_path / "jax.jsonl")})
    got = torch_exp.run({**hp, "device": "cpu",
                         "log_file": str(tmp_path / "port.jsonl")})
    logs = []
    for name in ("port.jsonl", "jax.jsonl"):
        with open(tmp_path / name) as fh:
            recs = [json.loads(line) for line in fh]
        hp_logged = {k: v for k, v in recs[0]["hp"].items()
                     if k not in ("device", "log_file")}
        logs.append((hp_logged, [r["loss"] for r in recs
                                 if r["event"] == "epoch"]))
    (got_hp, got_l), (want_hp, want_l) = logs
    assert got_hp == want_hp and "tf_net_dtype" not in got_hp
    assert "tf_net_dtype" not in got["hp"] and "tf_net_dtype" not in want["hp"]
    assert len(got_l) == len(want_l) == 4
    np.testing.assert_allclose(got_l, want_l, rtol=1e-2)
    np.testing.assert_allclose(got["error"], want["error"], rtol=5e-2)


@pytest.mark.parametrize("available", [False, True])
def test_default_device_is_the_card(monkeypatch, available):
    """With no device named the port takes the card, and raises where
    there is none; the CPU runs only when asked for."""
    from pinn_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    if available:
        assert resolve_device(None) == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import pinn_torch, pinn_torch.experiments.inf_cont_burgers\n"
            "import pinn_torch.experiments.ide_cont_burgers\n"
            "import pinn_torch.experiments.inf_cont_schrodinger\n"
            "import pinn_torch.experiments.serving_example\n"
            "import pinn_torch.experiments.inf_disc_burgers\n"
            "import pinn_torch.experiments.ide_disc_burgers\n"
            "import pinn_torch.experiments.inf_disc_allencahn\n"
            "import pinn_torch.experiments.ide_disc_kdv\n"
            "import pinn_torch.experiments.ide_cont_navierstokes\n"
            "import pinn_torch.experiments.run_campaign\n"
            "import pinn_torch.experiments.custom_pde_example\n"
            "import pinn_torch.experiments.inf_cont_burgers_bench\n"
            "import pinn_torch.experiments.ide_cont_burgers_bench\n"
            "import pinn_torch.experiments.viz, pinn_torch.utils.plotting\n"
            "import pinn_torch.datagen.allencahn_exact\n"
            "import pinn_torch.datagen.kdv_exact\n"
            "import pinn_torch.datagen.burgers_exact\n"
            "import pinn_torch.datagen.schrodinger_exact\n"
            "import pinn_torch.cli, pinn_torch.ops.diff\n"
            "import pinn_torch.problems.navierstokes\n"
            "import pinn_torch.datagen.navierstokes_spectral\n"
            "import pinn_torch.datagen.navierstokes_exact\n"
            "import pinn_torch.ops.fused_train, pinn_torch.optim.lbfgs\n"
            "import pinn_torch.ops.fused_schrodinger, pinn_torch.ops.residual\n"
            "import pinn_torch.ops.lbfgs_direction\n"
            "import pinn_torch.api, pinn_torch.ensemble, pinn_torch.export\n"
            "import pinn_torch.dtypes\n"
            "import pinn_torch.parallel, pinn_torch.parallel.distributed\n"
            "import pinn_torch.parallel.dp, pinn_torch.graft_entry\n"
            "import pinn_torch.parallel.tp, pinn_torch.parallel.mesh\n"
            "import pinn_torch.datagen.burgers_sympy\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pinn', 'datagen', 'experiments', "
            "'matplotlib', 'sympy'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def test_top_level_names():
    """``import pinn_torch`` gives the JAX package's top-level names
    (``pinn/__init__.py``) and loads neither jax nor matplotlib, and
    builds no kernel."""
    code = ("import sys\n"
            "import pinn_torch\n"
            "from pinn_torch.ops import _build\n"
            "names = ['PhysicsInformedNN', 'EnsemblePINN', 'Trainer', 'HP',\n"
            "         'load_hp', 'default_dtype', 'set_default_dtype', 'mlp',\n"
            "         'data', 'dtypes', 'ensemble', 'export', 'irk', 'optim',\n"
            "         'parallel', 'problems']\n"
            "missing = [n for n in names if not hasattr(pinn_torch, n)]\n"
            "assert not missing, missing\n"
            "assert pinn_torch.Trainer is __import__('pinn_torch.train').train.Trainer\n"
            "assert pinn_torch.optim.LbfgsConfig and pinn_torch.problems.kdv\n"
            "assert pinn_torch.mlp.taylor_apply and pinn_torch.load_hp\n"
            "assert pinn_torch.parallel.make_mesh and pinn_torch.parallel.shard_points\n"
            "assert pinn_torch.parallel.replicate\n"
            "assert pinn_torch.parallel.pad_points_with_weights\n"
            "assert pinn_torch.parallel.make_mesh_2d and pinn_torch.parallel.MODEL_AXIS\n"
            "assert pinn_torch.parallel.shard_params_tp and pinn_torch.optim.AdamRunner\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'matplotlib', 'pinn'))\n"
            "assert not bad, bad\n"
            "assert _build._LIBRARY is None\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


# ---------------------------------------------------------------------------
# RAR (residual-based adaptive refinement), float64 against the JAX run
# ---------------------------------------------------------------------------

RAR_HP = {"N_u": 30, "N_f": 400, "layers": [2, 12, 1], "log_frequency": 1000,
          "dtype": "float64", "rar_pool": 2000}


@pytest.fixture(scope="module")
def rar_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rar") / "init.npz")
    jax_checkpoint.save_npz(path, jax_mlp.init_mlp(
        jax.random.PRNGKey(5), RAR_HP["layers"], jax.numpy.float64))
    return path


def _recording_resamples(monkeypatch, trainer_cls, out):
    """Record the collocation points of every resampled batch."""
    resample = trainer_cls._resample

    def record(self, i):
        resample(self, i)
        out.append(np.asarray(self.batch["X_f"]))

    monkeypatch.setattr(trainer_cls, "_resample", record)


def test_rar_resampling_matches_jax(rar_ckpt, jax_exp, monkeypatch):
    """rar_pool: every resample scores the pool under the live iterate
    and keeps the same points as the JAX run, element for element."""
    import pinn.train
    import pinn_torch.train

    hp = {**RAR_HP, "tf_epochs": 10, "nt_epochs": 30, "nt_resample": 10,
          "init_checkpoint": rar_ckpt}
    draws = {"jax": [], "port": []}
    _recording_resamples(monkeypatch, pinn.train.Trainer, draws["jax"])
    _recording_resamples(monkeypatch, pinn_torch.train.Trainer, draws["port"])
    want = jax_exp.run(dict(hp))
    got = torch_exp.run({**hp, "device": "cpu"})
    assert got["rar_draws"] == len(draws["port"]) == len(draws["jax"]) >= 2
    for a, b in zip(draws["port"], draws["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["loss"], _jax_final_loss(want), rtol=1e-6)


def test_rar_init_matches_jax(rar_ckpt, jax_exp):
    """rar_init: one draw from the warm-start net before training, the
    same points as the JAX run's; the plain LHS draw differs."""
    hp = {**RAR_HP, "tf_epochs": 0, "nt_epochs": 10, "rar_init": True,
          "init_checkpoint": rar_ckpt}
    want = jax_exp.run(dict(hp))
    got = torch_exp.run({**hp, "device": "cpu"})
    assert got["rar_draws"] == 1
    np.testing.assert_array_equal(got["batch"]["X_f"].numpy(),
                                  np.asarray(want["batch"]["X_f"]))
    np.testing.assert_allclose(got["loss"], _jax_final_loss(want), rtol=1e-6)
    plain = torch_exp.run({**hp, "device": "cpu", "rar_init": False,
                           "nt_epochs": 0})
    assert not np.array_equal(plain["batch"]["X_f"].numpy(),
                              got["batch"]["X_f"].numpy())


def test_rar_pool_smaller_than_n_f_raises():
    with pytest.raises(ValueError, match="rar_pool"):
        torch_exp.run({**RAR_HP, "device": "cpu", "rar_pool": 100})
