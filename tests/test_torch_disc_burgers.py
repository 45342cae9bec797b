"""Discrete-time Burgers (q-stage IRK) on the port against the JAX
package: the stage derivatives, stage maps and both losses with their
gradients (float64 rtol 1e-10; float32 loss rtol 1e-5, gradients rtol
5e-4 with atol 5e-6 * max|g|), and ``inf_disc_burgers.run`` /
``ide_disc_burgers.run`` end to end in float64 from one JAX-saved init
(error, lambda pairs and logged losses rtol 1e-6, logged hp equal).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn import irk as jax_irk
from pinn.models import mlp as jax_mlp
from pinn.problems import burgers as jax_burgers
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec
from pinn_torch.experiments import ide_disc_burgers as torch_ide
from pinn_torch.experiments import inf_disc_burgers as torch_inf
from pinn_torch.problems import burgers
from pinn_torch.utils.checkpoint import ide_params_from_numpy, params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

NU = 0.01 / np.pi
DT = 0.8
LB, UB = np.array([-1.0]), np.array([1.0])
LAMBDA_PAIRS = [(0.0, -6.0), (1.3, -4.0)]
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


def _net(layers, seed, dtype):
    return jax_mlp.init_mlp(jax.random.PRNGKey(seed), layers, dtype)


def _t(a, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _x(n, seed, dtype):
    return (LB + (UB - LB) * np.random.RandomState(seed).rand(n, 1)).astype(dtype)


def _assert_grads(grads, want_g, dtype):
    """float64: rtol 1e-10; float32: rtol 5e-4 with atol 5e-6 max|g|."""
    want_g = [np.asarray(w) for w in jax.tree_util.tree_leaves(want_g)]
    gmax = max(float(np.abs(w).max()) for w in want_g)
    for g, w in zip(grads, want_g):
        if dtype == torch.float64:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                       atol=1e-12 * gmax)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=5e-4,
                                       atol=5e-6 * gmax)


@pytest.mark.parametrize("q", [8, 32])
def test_stage_derivs_and_u0_map_match_jax(q):
    jp = _net([1, 20, 20, q + 1], q, jnp.float64)
    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp],
                           "cpu", torch.float64)
    x = _x(40, q, np.float64)
    w_irk, _ = jax_irk.irk_weights(q)
    args = (LB, UB)
    for got, want in zip(
            burgers._stage_derivs(tp, _t(x, torch.float64),
                                  *(_t(a, torch.float64) for a in args)),
            jax_burgers._stage_derivs(jp, jnp.asarray(x), *args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                   atol=1e-12)
    got = burgers.u0_pred_disc_inference(
        tp, _t(x, torch.float64), _t(LB, torch.float64), _t(UB, torch.float64),
        NU, DT, _t(w_irk, torch.float64))
    want = jax_burgers.u0_pred_disc_inference(jp, jnp.asarray(x), LB, UB, NU,
                                              DT, jnp.asarray(w_irk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("q", [8, 32])
def test_loss_disc_inference_matches_jax(q, dtype):
    jdt, tdt = DTYPES[dtype]
    jp = _net([1, 20, 20, q + 1], 100 + q, jdt)
    rng = np.random.RandomState(q)
    x_0 = _x(40, q, dtype)
    u_0 = rng.randn(40, 1).astype(dtype)
    x_1 = np.vstack([LB, UB]).astype(dtype)
    w_irk = jax_irk.irk_weights(q)[0].astype(dtype)
    lb, ub = LB.astype(dtype), UB.astype(dtype)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_burgers.loss_disc_inference(
            p, jnp.asarray(x_0), jnp.asarray(u_0), jnp.asarray(x_1), lb, ub,
            NU, DT, jnp.asarray(w_irk))))(jp)

    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp],
                           "cpu", tdt)
    leaves = [a.requires_grad_(True) for a in pcodec.leaves(tp)]
    got = burgers.loss_disc_inference(
        tp, _t(x_0, tdt), _t(u_0, tdt), _t(x_1, tdt), _t(lb, tdt),
        _t(ub, tdt), NU, DT, _t(w_irk, tdt))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-10 if tdt == torch.float64 else 1e-5)
    _assert_grads(grads, want_g, tdt)


def _ide_pair(layers, l1, logl2, seed, jdt, tdt):
    net = _net(layers, seed, jdt)
    jp = jax_burgers.IdeParams(net=net, lambda1=jnp.array([l1], jdt),
                               log_lambda2=jnp.array([logl2], jdt))
    tp = ide_params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in net],
                               np.asarray(jp.lambda1),
                               np.asarray(jp.log_lambda2), "cpu", tdt)
    return jp, tp


@pytest.mark.parametrize("l1,logl2", LAMBDA_PAIRS)
def test_disc_ide_stage_maps_match_jax(l1, logl2):
    q = 8
    jp, tp = _ide_pair([1, 20, 20, q], l1, logl2, 3, jnp.float64,
                       torch.float64)
    w_irk, _ = jax_irk.irk_weights(q)
    alpha, beta = w_irk[:-1], w_irk[-1:]
    x = _x(40, 3, np.float64)
    want = jax_burgers.disc_ide_stage_maps(jp, jnp.asarray(x), LB, UB, DT,
                                           jnp.asarray(alpha), jnp.asarray(beta))
    got = burgers.disc_ide_stage_maps(
        tp, _t(x, torch.float64), _t(LB, torch.float64), _t(UB, torch.float64),
        DT, _t(alpha, torch.float64), _t(beta, torch.float64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("q", [8, 32])
@pytest.mark.parametrize("l1,logl2", LAMBDA_PAIRS)
def test_loss_disc_identification_matches_jax(l1, logl2, q, dtype):
    """Net and lambda gradients against jax.value_and_grad."""
    jdt, tdt = DTYPES[dtype]
    jp, tp = _ide_pair([1, 20, 20, q], l1, logl2, 200 + q, jdt, tdt)
    rng = np.random.RandomState(q)
    x_0, x_1 = _x(40, q, dtype), _x(40, q + 1, dtype)
    u_0, u_1 = (rng.randn(40, 1).astype(dtype) for _ in range(2))
    w_irk = jax_irk.irk_weights(q)[0].astype(dtype)
    alpha, beta = w_irk[:-1], w_irk[-1:]
    lb, ub = LB.astype(dtype), UB.astype(dtype)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_burgers.loss_disc_identification(
            p, jnp.asarray(x_0), jnp.asarray(u_0), jnp.asarray(x_1),
            jnp.asarray(u_1), lb, ub, DT, jnp.asarray(alpha),
            jnp.asarray(beta))))(jp)

    leaves = [a.requires_grad_(True) for a in pcodec.leaves(tp)]
    got = burgers.loss_disc_identification(
        tp, _t(x_0, tdt), _t(u_0, tdt), _t(x_1, tdt), _t(u_1, tdt),
        _t(lb, tdt), _t(ub, tdt), DT, _t(alpha, tdt), _t(beta, tdt))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-10 if tdt == torch.float64 else 1e-5)
    _assert_grads(grads, want_g, tdt)


# ---------------------------------------------------------------------------
# The experiments end to end, float64 from one JAX-saved init
# ---------------------------------------------------------------------------

INF_HP = {"N_n": 50, "q": 8, "layers": [1, 20, 20, 9], "tf_epochs": 20,
          "nt_epochs": 20, "log_frequency": 10, "dtype": "float64"}
IDE_HP = {"N_0": 40, "N_1": 40, "layers": [1, 20, 20, 0], "tf_epochs": 20,
          "nt_epochs": 20, "log_frequency": 10, "dtype": "float64"}


@pytest.fixture(scope="module")
def jax_exps():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import ide_disc_burgers
    import inf_disc_burgers
    return inf_disc_burgers, ide_disc_burgers


def _logs(path):
    """(logged hp without the port's device and the log path, epoch
    losses) of a log file."""
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    hp = {k: v for k, v in recs[0]["hp"].items()
          if k not in ("device", "log_file")}
    return hp, [r["loss"] for r in recs if r["event"] == "epoch"]


def _run_both(jax_run, torch_run, hp, tmp_path):
    want = jax_run({**hp, "log_file": str(tmp_path / "jax.jsonl")})
    got = torch_run({**hp, "device": "cpu",
                     "log_file": str(tmp_path / "port.jsonl")})
    (got_hp, got_l), (want_hp, want_l) = (
        _logs(tmp_path / f) for f in ("port.jsonl", "jax.jsonl"))
    assert got_hp == want_hp
    assert len(got_l) == len(want_l) > 0
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    return got, want


def test_inf_disc_run_matches_jax(jax_exps, tmp_path):
    ckpt = str(tmp_path / "init.npz")
    jax_checkpoint.save_npz(ckpt, _net(INF_HP["layers"], 7, jnp.float64))
    got, want = _run_both(jax_exps[0].run, torch_inf.run,
                          {**INF_HP, "init_checkpoint": ckpt}, tmp_path)
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-6)
    np.testing.assert_allclose(got["u_1_pred"], want["u_1_pred"], rtol=1e-6,
                               atol=1e-9)
    assert got["hp"]["layers"] == want["hp"]["layers"] == [1, 20, 20, 9]
    assert got["timing"]["lbfgs_iters"] > 0


def test_ide_disc_run_matches_jax(jax_exps, tmp_path):
    """Clean then noisy case, each from its own JAX-saved checkpoint;
    q = 81 from irk.auto_stages(0.8)."""
    ckpt = str(tmp_path / "init.npz")
    for i, path in enumerate((ckpt, ckpt.replace(".npz", "-noisy.npz"))):
        net = _net([1, 20, 20, 81], 11 + i, jnp.float64)
        jax_checkpoint.save_npz(path, jax_burgers.init_ide_params(net))
    got, want = _run_both(jax_exps[1].run, torch_ide.run,
                          {**IDE_HP, "init_checkpoint": ckpt}, tmp_path)
    for key in ("lambdas", "lambdas_noisy", "error"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    for key in ("U_0_pred", "U_1_pred"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-9,
                                   err_msg=key)
    assert got["hp"]["layers"] == want["hp"]["layers"] == [1, 20, 20, 81]
    assert set(got["timing"]) == {"clean", "noisy"}


@pytest.mark.parametrize("exp", [torch_inf, torch_ide])
def test_run_refuses_tpu_mesh(exp):
    with pytest.raises(ValueError, match="tpu_mesh"):
        exp.run({"tpu_mesh": True, "device": "cpu"})


def test_df32_runs_as_float64(tmp_path):
    """``net_impl: "df32"`` (the JAX package's double-f32 engine) is the
    float64 run on the port, bit for bit."""
    hp = {**INF_HP, "tf_epochs": 5, "nt_epochs": 5, "device": "cpu"}
    plain = torch_inf.run(dict(hp))
    df32 = torch_inf.run({**hp, "net_impl": "df32"})
    assert df32["error"] == plain["error"]
    assert df32["params"][0][0].dtype == torch.float64
    with pytest.raises(ValueError, match="float64"):
        torch_inf.run({**hp, "dtype": "float32", "net_impl": "df32"})


@pytest.mark.parametrize("name,overrides", [
    ("inf_disc_burgers", {"N_n": 30, "q": 8, "layers": [1, 10, 9]}),
    ("ide_disc_burgers", {"N_0": 20, "N_1": 20, "layers": [1, 10, 0]}),
])
def test_campaign_chains_stages(name, overrides, tmp_path):
    """``run_campaign.run_recipe`` runs the campaign's two stages, the
    second in float64 from the first's checkpoints (per case for the
    identification recipe), and holds the error to the budget."""
    from pinn_torch.experiments import run_campaign
    row = run_campaign.run_recipe(name, str(tmp_path), "cpu", quick=True,
                                  overrides={**overrides, "nt_epochs": 10})
    assert [s["dtype"] for s in row["stages"]] == ["float32", "float64"]
    assert row["met"] == (row["error"] <= run_campaign.BUDGETS[name])
    assert np.isfinite([s["error"] for s in row["stages"]]).all()
    cases = ["", "-noisy"] if name.startswith("ide") else [""]
    for stage in (1, 2):
        for case in cases:
            assert (tmp_path / f"{name}-stage{stage}{case}.npz").exists()
