"""The custom-PDE example (the heat equation on the facade's ``loss``
and ``taylor`` hooks) on the port against the JAX one: the draws bit
for bit, ``HeatPINN.loss`` and its gradients at one set of weights to
rtol 1e-10 (float64), and a cut run whose loss falls."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pinn.dtypes
import pinn_torch.dtypes
from pinn_torch import params as pcodec
from pinn_torch.experiments import custom_pde_example as torch_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

HP = {"N_u": 40, "N_f": 300, "layers": [2, 12, 12, 1], "tf_epochs": 0,
      "nt_epochs": 0, "log_frequency": 10 ** 6}


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import custom_pde_example
    return custom_pde_example


@pytest.fixture
def float64(monkeypatch):
    """Both packages' default dtype set to float64 for one test."""
    monkeypatch.setattr(pinn.dtypes, "_DEFAULT", jnp.float64)
    monkeypatch.setattr(pinn_torch.dtypes, "_DEFAULT", torch.float64)


@pytest.fixture
def both(jax_exp, float64):
    """Each package's run at HP, untrained; the port's net takes the JAX
    net's weights.  ``dtype: "float64"`` keeps JAX's x64 on (its
    ``resolve_dtype`` turns it off for float32)."""
    hp = {**HP, "dtype": "float64"}
    want = jax_exp.run(dict(hp))["pinn"]
    got = torch_exp.run({**hp, "device": "cpu"})["pinn"]
    got.set_weights(np.asarray(want.get_weights()))
    return got, want


def test_draws_bitwise(both):
    got, want = both
    for key in ("X_u", "u", "X_f"):
        g = got.trainer.batch[key].numpy()
        w = np.asarray(want.trainer.batch[key])
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w, err_msg=key)


def test_loss_and_grads_match_jax(both):
    got, want = both
    batch = got.trainer.batch
    wants, want_g = jax.value_and_grad(want.loss)(want.params,
                                                  want.trainer.batch)
    leaves = [a.clone().requires_grad_(True)
              for a in pcodec.leaves(got.params)]
    loss = got.loss(pcodec.rebuild(got.params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.detach().item(), float(wants), rtol=1e-10)
    want_leaves = jax.tree_util.tree_leaves(want_g)
    assert len(want_leaves) == len(grads)
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-14)


def test_cut_run_loss_falls(tmp_path):
    log_file = str(tmp_path / "log.jsonl")
    r = torch_exp.run({**HP, "device": "cpu", "tf_epochs": 10,
                       "nt_epochs": 10, "log_frequency": 5,
                       "log_file": log_file})
    with open(log_file) as fh:
        losses = [rec["loss"] for rec in map(json.loads, fh)
                  if rec["event"] == "epoch"]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert 0 < r["error"] < 1
    assert r["hp"]["N_f"] == HP["N_f"]
