"""Whole-run ``dtype: "bfloat16"`` on the port against the JAX
experiments, and the refusals both sides share.

Each experiment runs on both sides at a small size from one JAX-saved
npz (a bf16 init, stored widened to float32, which both loaders cast
back to bf16) with ``log_frequency: 1``.  Bars:
- the step-0 loss: rtol 1e-2 (measured: equal on all eight);
- the Adam phase's logged losses: rtol 5e-2.  The two sides do not
  round at the same points (XLA may keep a fused expression's
  intermediates wider than bf16; PyTorch rounds each operation's
  result), so the runs part by a bf16 ulp (2^-8 relative) here and
  there and drift; measured at most 2.1e-2 over these runs
  (ide_cont_burgers, clean case; the first L-BFGS loss at most 1.6e-2,
  7.8e-3 with the float32 iterate);
- the L-BFGS phase: both sides reach it and stay finite.  Its stopping
  tests (tolX, tolFun) fire at different iterations once the iterates
  differ by an ulp, so its losses are not compared;
- the result's parameters are bf16 on both sides (with
  ``nt_vector_dtype: "float32"`` the L-BFGS iterate is float32 and the
  parameters it hands back are bf16 again).
"""

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
from pinn.problems import kdv as jax_kdv
from pinn.problems import navierstokes as jax_ns
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _net(layers, seed):
    return jax_mlp.init_mlp(jax.random.PRNGKey(seed), layers, jnp.bfloat16)


def _ide2(init, layers, seed):
    return [init(_net(layers, seed)), init(_net(layers, seed + 1))]


# name: (hp, the initial parameters: one a case)
CASES = {
    "inf_cont_burgers": (
        {"N_u": 50, "N_f": 200, "layers": [2, 20, 20, 1]},
        lambda: [_net([2, 20, 20, 1], 1)]),
    "ide_cont_burgers": (
        {"N_u": 200, "layers": [2, 20, 20, 1]},
        lambda: _ide2(jax_burgers.init_ide_params, [2, 20, 20, 1], 2)),
    "inf_cont_schrodinger": (
        {"N_0": 30, "N_b": 30, "N_f": 300, "layers": [2, 20, 20, 2]},
        lambda: [_net([2, 20, 20, 2], 4)]),
    "inf_disc_burgers": (
        {"N_n": 50, "q": 8, "layers": [1, 20, 20, 9]},
        lambda: [_net([1, 20, 20, 9], 5)]),
    "ide_disc_burgers": (
        {"N_0": 40, "N_1": 40, "layers": [1, 20, 20, 0]},
        lambda: _ide2(jax_burgers.init_ide_params, [1, 20, 20, 81], 6)),
    "inf_disc_allencahn": (
        {"N_n": 50, "q": 8, "layers": [1, 20, 20, 9]},
        lambda: [_net([1, 20, 20, 9], 8)]),
    "ide_disc_kdv": (
        {"N_0": 40, "N_1": 40, "q": 8, "layers": [1, 20, 20, 0]},
        lambda: _ide2(jax_kdv.init_ide_params, [1, 20, 20, 8], 9)),
    "ide_cont_navierstokes": (
        {"N_u": 200, "layers": [3, 10, 10, 2], "grid_nx": 16, "grid_ny": 16,
         "grid_nt": 5},
        lambda: _ide2(jax_ns.init_ide_params, [3, 10, 10, 2], 11)),
}
TF, NT = 10, 5


@pytest.fixture(scope="module")
def jax_exps():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import importlib
    return lambda name: importlib.import_module(name)


def _port(name):
    import importlib
    return importlib.import_module(f"pinn_torch.experiments.{name}")


def _runs(path):
    """The logged runs of a log file (one a case), each a pair (Adam
    losses, L-BFGS losses)."""
    runs, cur = [], ([], [])
    for line in open(path):
        r = json.loads(line)
        if r["event"] == "epoch":
            cur[r["phase"] == "nt_epoch"].append(r["loss"])
        elif r["event"] == "end":
            runs.append(cur)
            cur = ([], [])
    return runs


def _save_init(name, tmp_path):
    path = str(tmp_path / "init.npz")
    for i, p in enumerate(CASES[name][1]()):
        jax_checkpoint.save_npz(
            path if i == 0 else path.replace(".npz", "-noisy.npz"),
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p))
    return path


@pytest.mark.parametrize("name", list(CASES))
def test_bfloat16_run_matches_jax(name, jax_exps, tmp_path):
    hp = {**CASES[name][0], "dtype": "bfloat16", "tf_epochs": TF,
          "nt_epochs": NT, "log_frequency": 1,
          "init_checkpoint": _save_init(name, tmp_path)}
    want = jax_exps(name).run({**hp, "log_file": str(tmp_path / "j.jsonl")})
    got = _port(name).run({**hp, "device": "cpu",
                           "log_file": str(tmp_path / "p.jsonl")})
    want_runs, got_runs = (_runs(tmp_path / f) for f in ("j.jsonl",
                                                          "p.jsonl"))
    assert len(got_runs) == len(want_runs) == len(CASES[name][1]())
    for (g_adam, g_lb), (w_adam, w_lb) in zip(got_runs, want_runs):
        assert len(g_adam) == len(w_adam) == TF
        np.testing.assert_allclose(g_adam[0], w_adam[0], rtol=1e-2)
        np.testing.assert_allclose(g_adam, w_adam, rtol=5e-2)
        assert g_lb and w_lb and np.isfinite(g_lb + w_lb).all()
    for key in ("error", "lambdas", "lambdas_noisy"):
        if key in want:
            assert np.isfinite(got[key]).all() and np.isfinite(
                want[key]).all(), key
    leaf = pcodec.leaves(got["params"])[0]
    assert leaf.dtype == torch.bfloat16
    assert jax.tree_util.tree_leaves(want["params"])[0].dtype == jnp.bfloat16


def test_bfloat16_with_float32_iterate(jax_exps, tmp_path):
    """``nt_vector_dtype: "float32"`` keeps the L-BFGS iterate and
    history in float32 around the bf16 net on both sides: the whole
    logged Adam phase and the first L-BFGS loss as above."""
    name = "inf_cont_burgers"
    hp = {**CASES[name][0], "dtype": "bfloat16", "tf_epochs": TF,
          "nt_epochs": NT, "log_frequency": 1, "nt_vector_dtype": "float32",
          "init_checkpoint": _save_init(name, tmp_path)}
    jax_exps(name).run({**hp, "log_file": str(tmp_path / "j.jsonl")})
    got = _port(name).run({**hp, "device": "cpu",
                           "log_file": str(tmp_path / "p.jsonl")})
    (g_adam, g_lb), = _runs(tmp_path / "p.jsonl")
    (w_adam, w_lb), = _runs(tmp_path / "j.jsonl")
    np.testing.assert_allclose(g_adam, w_adam, rtol=5e-2)
    np.testing.assert_allclose(g_lb[0], w_lb[0], rtol=5e-2)
    assert pcodec.leaves(got["params"])[0].dtype == torch.bfloat16


def test_custom_pde_runs_in_the_default_dtype(jax_exps):
    """The custom-PDE example's facade runs in the package's default
    dtype whatever hp["dtype"] says, on both sides: the bf16 run is the
    float32 run."""
    hp = {"N_u": 40, "N_f": 300, "layers": [2, 12, 12, 1], "tf_epochs": 5,
          "nt_epochs": 5, "log_frequency": 10 ** 6, "device": "cpu"}
    exp = _port("custom_pde_example")
    got = exp.run({**hp, "dtype": "bfloat16"})
    want = exp.run({**hp, "dtype": "float32"})
    assert got["error"] == want["error"]
    jhp = {k: v for k, v in hp.items() if k != "device"}
    jexp = jax_exps("custom_pde_example")
    assert jexp.run({**jhp, "dtype": "bfloat16"})["error"] == \
        jexp.run({**jhp, "dtype": "float32"})["error"]


@pytest.mark.parametrize("name,extra,match", [
    ("inf_cont_burgers", {"fused_residual": True}, "requires dtype=float32"),
    ("ide_cont_burgers", {"fused_residual": True}, "requires dtype=float32"),
    ("inf_cont_schrodinger", {"fused_residual": True},
     "requires dtype=float32"),
    ("inf_cont_burgers", {"net_impl": "df32"}, "requires dtype=float64"),
    ("inf_disc_burgers", {"net_impl": "df32"}, "requires dtype=float64"),
])
def test_bfloat16_refusals_on_both_sides(name, extra, match, jax_exps):
    """Where the JAX experiment raises on bf16, the port raises too."""
    hp = {**CASES[name][0], "dtype": "bfloat16", "tf_epochs": 1,
          "nt_epochs": 1, **extra}
    with pytest.raises(ValueError, match=match):
        jax_exps(name).run(dict(hp))
    with pytest.raises(ValueError, match=match):
        _port(name).run({**hp, "device": "cpu"})


def test_serving_example_refuses_bfloat16(jax_exps):
    """The JAX serving example fails its own served-vs-in-process check
    in bfloat16; the port refuses the run before training."""
    hp = {"members": 2, "N_u": 50, "N_f": 300, "layers": [2, 10, 10, 1],
          "tf_epochs": 2, "nt_epochs": 2, "dtype": "bfloat16"}
    with pytest.raises(AssertionError, match="deviates"):
        jax_exps("serving_example").run(dict(hp))
    with pytest.raises(ValueError, match="bfloat16"):
        _port("serving_example").run({**hp, "device": "cpu"})


def test_resolve_dtype_names_the_three_dtypes():
    from pinn_torch.experiments._common import resolve_dtype
    assert [resolve_dtype({"dtype": d}) for d in
            ("float32", "float64", "bfloat16")] == [
        torch.float32, torch.float64, torch.bfloat16]
    assert resolve_dtype({}) == torch.float32
    with pytest.raises(ValueError, match="float32, float64 or bfloat16"):
        resolve_dtype({"dtype": "float16"})


def test_jax_bfloat16_checkpoint_loads(tmp_path):
    """A JAX bf16 npz holds raw bf16 bits; the port reads them exactly,
    and its own bf16 save (float32) loads back into JAX."""
    from pinn_torch.utils import checkpoint
    net = _net([2, 6, 1], 3)
    path = str(tmp_path / "bf16.npz")
    jax_checkpoint.save_npz(path, net)
    like = [(torch.zeros(w.shape, dtype=torch.bfloat16),
             torch.zeros(b.shape, dtype=torch.bfloat16)) for w, b in net]
    got, _ = checkpoint.load_npz(path, like=like)
    for g, w in zip(pcodec.leaves(got), jax.tree_util.tree_leaves(net)):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w.astype(jnp.float32)))
    back = str(tmp_path / "port.npz")
    checkpoint.save_npz(back, got)
    loaded, _ = jax_checkpoint.load_npz(back, like=net)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(net)):
        assert a.dtype == jnp.bfloat16 and np.array_equal(
            np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32)))
