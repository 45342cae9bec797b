"""Discrete-time KdV identification (q-stage IRK, order-3 stream) on the
port against the JAX package: the order-3 stage derivatives, the stage
maps, the loss with its net and lambda gradients (float64 rtol 1e-10;
float32 loss rtol 1e-5, gradients rtol 5e-4 with atol 5e-6 * max|g|),
``lambda_error``, ``prep_data``'s draws bit for bit (noise drawn even
at 0), and ``ide_disc_kdv.run`` end to end: float64 from one JAX-saved
init (lambda pairs, error and logged losses rtol 1e-6, logged hp
equal), and one float32 run whose losses fall.
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
from pinn.problems import kdv as jax_kdv
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec
from pinn_torch.experiments import ide_disc_kdv as torch_exp
from pinn_torch.problems import kdv
from pinn_torch.utils.checkpoint import ide_params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

DT = 0.6
LB, UB = np.array([-1.0]), np.array([1.0])
LAMBDA_PAIRS = [(0.0, -6.0), (1.3, -4.0)]
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import ide_disc_kdv
    return ide_disc_kdv


def _case(q, l1, logl2, seed, dtype):
    """JAX IdeParams on [1, 20, 20, q], the port's copy, seeded inputs."""
    jdt, tdt = DTYPES[dtype]
    net = jax_mlp.init_mlp(jax.random.PRNGKey(seed), [1, 20, 20, q], jdt)
    jp = jax_kdv.IdeParams(net=net, lambda1=jnp.array([l1], jdt),
                           log_lambda2=jnp.array([logl2], jdt))
    tp = ide_params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in net],
                               np.asarray(jp.lambda1), np.asarray(jp.log_lambda2),
                               "cpu", tdt)
    rng = np.random.RandomState(seed)
    w_irk = jax_irk.irk_weights(q)[0]
    arrays = {"x_0": LB + (UB - LB) * rng.rand(40, 1), "u_0": rng.randn(40, 1),
              "x_1": LB + (UB - LB) * rng.rand(40, 1), "u_1": rng.randn(40, 1),
              "lb": LB, "ub": UB, "alpha": w_irk[:-1], "beta": w_irk[-1:]}
    arrays = {k: a.astype(dtype) for k, a in arrays.items()}
    return jp, tp, arrays, {k: torch.as_tensor(a) for k, a in arrays.items()}


@pytest.mark.parametrize("q", [8, 32])
@pytest.mark.parametrize("l1,logl2", LAMBDA_PAIRS)
def test_stage_derivs3_and_maps_match_jax(l1, logl2, q):
    jp, tp, a, t = _case(q, l1, logl2, q, "float64")
    for g, w in zip(kdv._stage_derivs3(tp.net, t["x_0"], t["lb"], t["ub"]),
                    jax_kdv._stage_derivs3(jp.net, a["x_0"], a["lb"], a["ub"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)
    got = kdv.disc_ide_stage_maps(tp, t["x_0"], t["lb"], t["ub"], DT,
                                  t["alpha"], t["beta"])
    want = jax_kdv.disc_ide_stage_maps(jp, a["x_0"], a["lb"], a["ub"], DT,
                                       a["alpha"], a["beta"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)
    assert kdv.lambda_error(tp) == pytest.approx(jax_kdv.lambda_error(jp),
                                                 rel=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("q", [8, 32])
@pytest.mark.parametrize("l1,logl2", LAMBDA_PAIRS)
def test_loss_disc_identification_matches_jax(l1, logl2, q, dtype):
    """Net and lambda gradients against jax.value_and_grad."""
    jp, tp, a, t = _case(q, l1, logl2, 300 + q, dtype)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_kdv.loss_disc_identification(
            p, a["x_0"], a["u_0"], a["x_1"], a["u_1"], a["lb"], a["ub"], DT,
            a["alpha"], a["beta"])))(jp)
    leaves = [x.requires_grad_(True) for x in pcodec.leaves(tp)]
    got = kdv.loss_disc_identification(tp, t["x_0"], t["u_0"], t["x_1"],
                                       t["u_1"], t["lb"], t["ub"], DT,
                                       t["alpha"], t["beta"])
    grads = torch.autograd.grad(got, leaves)
    f64 = dtype == "float64"
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-10 if f64 else 1e-5)
    want_g = [np.asarray(w) for w in jax.tree_util.tree_leaves(want_g)]
    gmax = max(float(np.abs(w).max()) for w in want_g)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), w,
                                   rtol=1e-10 if f64 else 5e-4,
                                   atol=(1e-12 if f64 else 5e-6) * gmax)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_prep_data_equal(jax_exp, noise):
    """Same seed, same draws: every array equal and the numpy stream
    left in the same place; the noise draws happen even at noise 0."""
    np.random.seed(1234)
    got = torch_exp.prep_data(199, 201, 50, noise=noise)
    got_next = np.random.rand(3)
    np.random.seed(1234)
    want = jax_exp.prep_data(199, 201, 50, noise=noise)
    want_next = np.random.rand(3)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got_next, want_next)
    np.random.seed(1234)
    np.random.choice(512, 199, replace=False)
    np.random.randn(199, 1)
    np.random.choice(512, 201, replace=False)
    np.random.randn(201, 1)
    np.testing.assert_array_equal(np.random.rand(3), got_next)


def test_missing_dataset_raises(monkeypatch, tmp_path):
    """A missing dataset is generated and written, as in the JAX
    experiment (tests/test_torch_datagen.py); where it cannot be written
    (its directory is missing too) the write raises, naming the file."""
    monkeypatch.setattr(torch_exp, "DATASET",
                        str(tmp_path / "missing" / "KdV.npz"))
    with pytest.raises(FileNotFoundError, match="KdV.npz"):
        torch_exp.run({"q": 8, "layers": [1, 8, 0], "device": "cpu"})


def test_run_refuses_tpu_mesh():
    with pytest.raises(ValueError, match="tpu_mesh"):
        torch_exp.run({"tpu_mesh": True, "device": "cpu"})


HP = {"N_0": 40, "N_1": 40, "q": 8, "layers": [1, 20, 20, 0],
      "tf_epochs": 20, "nt_epochs": 30, "log_frequency": 10}


def _logs(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    hp = {k: v for k, v in recs[0]["hp"].items()
          if k not in ("device", "log_file")}
    runs, cur = [], []
    for r in recs:
        if r["event"] == "epoch":
            cur.append(r["loss"])
        elif r["event"] == "end":
            runs.append(cur)
            cur = []
    return hp, runs


def test_float64_run_matches_jax(jax_exp, tmp_path):
    """Clean and noisy cases, each from its own JAX-saved checkpoint."""
    ckpt = str(tmp_path / "init.npz")
    for i, path in enumerate((ckpt, ckpt.replace(".npz", "-noisy.npz"))):
        net = jax_mlp.init_mlp(jax.random.PRNGKey(21 + i), [1, 20, 20, 8],
                               jnp.float64)
        jax_checkpoint.save_npz(path, jax_kdv.init_ide_params(net))
    hp = {**HP, "dtype": "float64", "init_checkpoint": ckpt}
    want = jax_exp.run({**hp, "log_file": str(tmp_path / "jax.jsonl")})
    got = torch_exp.run({**hp, "device": "cpu",
                         "log_file": str(tmp_path / "port.jsonl")})
    (got_hp, got_runs), (want_hp, want_runs) = (
        _logs(tmp_path / f) for f in ("port.jsonl", "jax.jsonl"))
    assert got_hp == want_hp
    assert [len(r) for r in got_runs] == [len(r) for r in want_runs] == [5, 5]
    np.testing.assert_allclose(sum(got_runs, []), sum(want_runs, []),
                               rtol=1e-6)
    for key in ("lambdas", "lambdas_noisy", "error"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    for key in ("U_0_pred", "U_1_pred"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-9,
                                   err_msg=key)
    assert got["hp"]["layers"] == want["hp"]["layers"] == [1, 20, 20, 8]


def test_float32_run_falls(tmp_path):
    """The recipe's dtype: both cases' logged losses fall, the results
    are finite and the parameters float32."""
    got = torch_exp.run({**HP, "device": "cpu",
                         "log_file": str(tmp_path / "port.jsonl")})
    _, runs = _logs(tmp_path / "port.jsonl")
    assert len(runs) == 2
    for losses in runs:
        assert losses[-1] < losses[0]
    assert np.isfinite([*got["lambdas"], *got["lambdas_noisy"],
                        got["error"]]).all()
    assert all(a.dtype == torch.float32 for a in pcodec.leaves(got["params"]))
