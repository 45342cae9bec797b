"""Discrete-time Allen–Cahn (q-stage IRK, periodic) on the port against
the JAX package: the stage map, the periodic boundary terms and the
loss with its gradients (float64 rtol 1e-10; float32 loss rtol 1e-5,
gradients rtol 5e-4 with atol 5e-6 * max|g|), ``prep_data``'s draws bit
for bit, and ``inf_disc_allencahn.run`` end to end in float64 from one
JAX-saved init (error and logged losses rtol 1e-6, logged hp equal).
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
from pinn.problems import allencahn as jax_allencahn
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec
from pinn_torch.experiments import inf_disc_allencahn as torch_exp
from pinn_torch.problems import allencahn
from pinn_torch.utils.checkpoint import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

DT = 0.8
LB, UB = np.array([-1.0]), np.array([1.0])
X_BND = np.array([[-1.0], [1.0]])
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import inf_disc_allencahn
    return inf_disc_allencahn


def _case(q, seed, dtype):
    """A JAX net [1, 20, 20, q+1], its port copy, and seeded inputs."""
    jdt, tdt = DTYPES[dtype]
    jp = jax_mlp.init_mlp(jax.random.PRNGKey(seed), [1, 20, 20, q + 1], jdt)
    tp = params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp],
                           "cpu", tdt)
    rng = np.random.RandomState(seed)
    arrays = {"x_0": LB + (UB - LB) * rng.rand(40, 1),
              "u_0": rng.randn(40, 1), "x_bnd": X_BND, "lb": LB, "ub": UB,
              "w": jax_irk.irk_weights(q)[0]}
    arrays = {k: a.astype(dtype) for k, a in arrays.items()}
    tens = {k: torch.as_tensor(a) for k, a in arrays.items()}
    return jp, tp, arrays, tens


@pytest.mark.parametrize("q", [8, 32])
def test_stage_map_and_bc_terms_match_jax(q):
    jp, tp, a, t = _case(q, q, "float64")
    got = allencahn.u0_pred_disc_inference(tp, t["x_0"], t["lb"], t["ub"], DT,
                                           t["w"])
    want = jax_allencahn.u0_pred_disc_inference(jp, a["x_0"], a["lb"],
                                                a["ub"], DT, a["w"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)
    for g, w in zip(
            allencahn.periodic_bc_terms(tp, t["x_bnd"], t["lb"], t["ub"]),
            jax_allencahn.periodic_bc_terms(jp, a["x_bnd"], a["lb"], a["ub"])):
        assert g.shape == (q + 1,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(
        allencahn.predict_u1(tp, t["x_0"], t["lb"], t["ub"]).numpy(),
        np.asarray(jax_allencahn.predict_u1(jp, a["x_0"], a["lb"], a["ub"])),
        rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("q", [8, 32])
def test_loss_disc_inference_matches_jax(q, dtype):
    jp, tp, a, t = _case(q, 50 + q, dtype)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_allencahn.loss_disc_inference(
            p, a["x_0"], a["u_0"], a["x_bnd"], a["lb"], a["ub"], DT,
            a["w"])))(jp)
    leaves = [x.requires_grad_(True) for x in pcodec.leaves(tp)]
    got = allencahn.loss_disc_inference(tp, t["x_0"], t["u_0"], t["x_bnd"],
                                        t["lb"], t["ub"], DT, t["w"])
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
    left in the same place (noise is drawn only when positive)."""
    np.random.seed(1234)
    got = torch_exp.prep_data(200, 100, noise=noise)
    got_next = np.random.rand(3)
    np.random.seed(1234)
    want = jax_exp.prep_data(200, 100, noise=noise)
    want_next = np.random.rand(3)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got_next, want_next)


def test_missing_dataset_raises(monkeypatch, tmp_path):
    """A missing dataset is generated and written, as in the JAX
    experiment (tests/test_torch_datagen.py); where it cannot be written
    (its directory is missing too) the write raises, naming the file."""
    monkeypatch.setattr(torch_exp, "DATASET",
                        str(tmp_path / "missing" / "AC.npz"))
    with pytest.raises(FileNotFoundError, match="AC.npz"):
        torch_exp.run({"q": 8, "layers": [1, 8, 9], "device": "cpu"})


def test_run_refuses_tpu_mesh():
    with pytest.raises(ValueError, match="tpu_mesh"):
        torch_exp.run({"tpu_mesh": True, "device": "cpu"})


def test_run_matches_jax(jax_exp, tmp_path):
    """tests/fixtures/hp_smoke_allencahn.json (float64) from one
    JAX-saved init."""
    with open(os.path.join(REPO, "tests", "fixtures",
                           "hp_smoke_allencahn.json")) as fh:
        hp = json.load(fh)
    ckpt = str(tmp_path / "init.npz")
    jax_checkpoint.save_npz(ckpt, jax_mlp.init_mlp(
        jax.random.PRNGKey(3), hp["layers"], jnp.float64))
    hp = {**hp, "init_checkpoint": ckpt}
    want = jax_exp.run({**hp, "log_file": str(tmp_path / "jax.jsonl")})
    got = torch_exp.run({**hp, "device": "cpu",
                         "log_file": str(tmp_path / "port.jsonl")})
    logs = []
    for name in ("port.jsonl", "jax.jsonl"):
        with open(tmp_path / name) as fh:
            recs = [json.loads(line) for line in fh]
        logs.append(({k: v for k, v in recs[0]["hp"].items()
                      if k not in ("device", "log_file")},
                     [r["loss"] for r in recs if r["event"] == "epoch"]))
    (got_hp, got_l), (want_hp, want_l) = logs
    assert got_hp == want_hp and got_hp["layers"] == [1, 16, 16, 9]
    assert len(got_l) == len(want_l) == 4
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-6)
    np.testing.assert_allclose(got["u_1_pred"], want["u_1_pred"], rtol=1e-6,
                               atol=1e-9)
