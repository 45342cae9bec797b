"""The port's data-parallel tier (``pinn_torch.parallel``, the fused
``*_loss_dp`` wrappers, ``tpu_mesh`` in the two flagship experiments)
against the JAX package's GSPMD and ``shard_map`` runs on the eight
virtual CPU devices of tests/conftest.py.

Both sides take the same numpy-seeded inputs and weights.  Bars:
- the eager sharded loss and gradients, float32 (tests/test_parallel.py
  :40-58): loss rtol 1e-6, gradients rtol 2e-5 with atol 1e-7; the
  padded weighted loss in float64: rtol 1e-12 against its own unpadded
  loss, 1e-10 against JAX's;
- the fused DP losses on their kernels' plain versions against the JAX
  DP wrappers in interpret mode (the kernel bars): loss rtol 1e-5,
  gradients rtol 5e-4 with atol 5e-6 * max|g|;
- whole ``tpu_mesh: 8`` runs from one JAX-saved init: the final loss
  in float64 to rtol 1e-6; in float32 the rel-L2 error to rtol 5e-2
  (tests/test_parallel.py:175-198).
Every sum of the port's reduction has a fixed order, so two calls are
bitwise equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.models import mlp as jax_mlp
from pinn.ops import pallas_schrodinger, pallas_train
from pinn.parallel import make_mesh as jax_make_mesh
from pinn.parallel import pad_points_with_weights as jax_pad
from pinn.parallel import replicate as jax_replicate
from pinn.parallel import shard_points as jax_shard_points
from pinn.problems import burgers as jax_burgers
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec
from pinn_torch.experiments import inf_cont_burgers as torch_burgers_exp
from pinn_torch.experiments import inf_cont_schrodinger as torch_schr_exp
from pinn_torch.ops import fused_schrodinger, fused_train
from pinn_torch.parallel import (data_parallel, make_mesh,
                                 pad_points_with_weights)
from pinn_torch.problems import burgers
from pinn_torch.train import Trainer
from pinn_torch.utils.checkpoint import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

NU = 0.01 / np.pi
LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)
SLB = np.array([-5.0, 0.0], np.float32)
SUB = np.array([5.0, np.pi / 2], np.float32)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh8():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    return jax_make_mesh(8)


def _pairs(layers, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [((rng.randn(a, b) * np.sqrt(2.0 / (a + b))).astype(dtype),
             (0.1 * rng.randn(b)).astype(dtype))
            for a, b in zip(layers[:-1], layers[1:])]


def _burgers_batch(seed, n_u, n_f, dtype=np.float32):
    rng = np.random.RandomState(seed)
    b = {"X_u": LB + (UB - LB) * rng.rand(n_u, 2), "u": rng.rand(n_u, 1),
         "X_f": LB + (UB - LB) * rng.rand(n_f, 2)}
    return {k: v.astype(dtype) for k, v in b.items()}


def _schrodinger_batch(seed, n0, n_f, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x0 = SLB[0] + (SUB[0] - SLB[0]) * rng.rand(n0, 1)
    tb = rng.rand(n0, 1) * (SUB[1] - SLB[1])
    b = {"X0": np.hstack([x0, np.zeros((n0, 1))]), "H0": rng.randn(n0, 2),
         "X_lb": np.hstack([np.full((n0, 1), SLB[0]), tb]),
         "X_ub": np.hstack([np.full((n0, 1), SUB[0]), tb]),
         "X_f": SLB + (SUB - SLB) * rng.rand(n_f, 2)}
    return {k: v.astype(dtype) for k, v in b.items()}


def _torch_value_and_grad(loss_fn, pairs, batch, dtype=torch.float32):
    params = params_from_numpy(pairs, "cpu", dtype)
    leaves = [a.requires_grad_(True) for a in pcodec.leaves(params)]
    tb = {k: torch.as_tensor(v, dtype=dtype) for k, v in batch.items()}
    val = loss_fn(params, tb)
    grads = torch.autograd.grad(val, leaves)
    return val.detach(), [g.numpy() for g in grads]


def _jax_value_and_grad(loss_fn, pairs, batch):
    params = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    val, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    return float(val), [np.asarray(a) for wb in grads for a in wb]


def _assert_grads(got, want, rtol, atol=0.0, scale=0.0):
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g, w, rtol=rtol,
            atol=atol + scale * max(float(np.abs(x).max()) for x in want))


# ---------------------------------------------------------------------------
# The mesh and the padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, shards, dtype", [
    (5, 4, None), (13, 8, None), (64, 8, None), (7, 1, None),
    (10001, 3, np.float32), (100, 8, np.float64)])
def test_pad_points_with_weights_bitwise_jax(n, shards, dtype):
    X = np.random.RandomState(n).rand(n, 2)
    got, want = pad_points_with_weights(X, shards, dtype), jax_pad(X, shards,
                                                                   dtype)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_make_mesh_never_shrinks(monkeypatch):
    """``make_mesh(n)`` raises with fewer than n cards (JAX takes what it
    has); named devices may repeat; no card means no default mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="never shrinks"):
        make_mesh(2)
    assert make_mesh().devices == (torch.device("cuda", 0),)
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4} and mesh.size == 4


def test_init_distributed_backend_follows_device(monkeypatch):
    """NCCL on the card, gloo on the CPU: a backend that disagrees
    raises before any process group is made."""
    from pinn_torch.parallel import distributed as pdist
    with pytest.raises(ValueError, match="'gloo'"):
        pdist.init_distributed("localhost:1", 1, 0, backend="nccl",
                               device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="'nccl'"):
        pdist.init_distributed("localhost:1", 1, 0, backend="gloo",
                               device="cuda")


# ---------------------------------------------------------------------------
# The eager loss over 8 shards
# ---------------------------------------------------------------------------

def _eager_burgers(dtype=torch.float32):
    lb, ub = torch.as_tensor(LB, dtype=dtype), torch.as_tensor(UB, dtype=dtype)

    def loss(p, b):
        return burgers.loss_cont_inference(p, b["X_u"], b["u"], b["X_f"],
                                           lb, ub, NU,
                                           f_weights=b.get("f_w"))
    return loss


def _jax_eager_burgers(dtype=jnp.float32):
    lb, ub = jnp.asarray(LB, dtype), jnp.asarray(UB, dtype)

    def loss(p, b):
        return jax_burgers.loss_cont_inference(p, b["X_u"], b["u"], b["X_f"],
                                               lb, ub, NU,
                                               f_weights=b.get("f_w"))
    return loss


def test_eager_sharded_loss_and_grads(mesh8, jax_mesh8):
    """8 shards of every point array (as tests/test_parallel.py shards
    them) against the port's single-shard loss and JAX's GSPMD run."""
    pairs = _pairs([2, 16, 16, 1], 0)
    batch = _burgers_batch(0, 16, 64)
    eager = _eager_burgers()
    dp = data_parallel(eager, mesh8, ("X_u", "u", "X_f"))
    val, grads = _torch_value_and_grad(dp, pairs, batch)
    val1, grads1 = _torch_value_and_grad(eager, pairs, batch)
    np.testing.assert_allclose(float(val), float(val1), rtol=1e-6)
    _assert_grads(grads, grads1, rtol=2e-5, atol=1e-7)

    jb = {k: jax_shard_points(jnp.asarray(v), jax_mesh8)
          for k, v in batch.items()}
    jparams = jax_replicate(tuple((jnp.asarray(w), jnp.asarray(b))
                                  for w, b in pairs), jax_mesh8)
    jloss = _jax_eager_burgers()
    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams, jb)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)
    _assert_grads(grads, [np.asarray(a) for wb in jgrads for a in wb],
                  rtol=2e-5, atol=1e-7)

    again, grads2 = _torch_value_and_grad(dp, pairs, batch)
    assert torch.equal(val, again)
    assert all(np.array_equal(a, b) for a, b in zip(grads, grads2))


def test_padded_weighted_loss(mesh8, jax_mesh8):
    """N_f = 13 padded to 16 with zero weights over 8 shards, each
    shard's weights x8: the unpadded mean (float64)."""
    pairs = _pairs([2, 8, 1], 1, np.float64)
    batch = _burgers_batch(1, 4, 13, np.float64)
    eager = _eager_burgers(torch.float64)
    plain, _ = _torch_value_and_grad(eager, pairs, batch, torch.float64)

    Xp, w = pad_points_with_weights(batch["X_f"], 8)
    padded = {**batch, "X_f": Xp, "f_w": w}
    dp = data_parallel(lambda p, b: eager(p, {**b, "f_w": b["f_w"] * 8}),
                       mesh8, ("X_f", "f_w"))
    val, grads = _torch_value_and_grad(dp, pairs, padded, torch.float64)
    np.testing.assert_allclose(float(val), float(plain), rtol=1e-12)

    jpadded = {k: jnp.asarray(v) for k, v in padded.items()}
    jpadded["X_f"] = jax_shard_points(jpadded["X_f"], jax_mesh8)
    jpadded["f_w"] = jax_shard_points(jpadded["f_w"], jax_mesh8)
    jval, jgrads = _jax_value_and_grad(_jax_eager_burgers(jnp.float64),
                                       pairs, jpadded)
    np.testing.assert_allclose(float(val), jval, rtol=1e-10)
    _assert_grads(grads, jgrads, rtol=1e-10, atol=1e-14)


def test_trainer_on_a_mesh_matches_single_device(mesh8):
    """A whole Adam + L-BFGS trajectory through the DP loss and
    ``Trainer(mesh=...)`` against the unsharded one (the bars of
    tests/test_parallel.py:132-136)."""
    pairs = _pairs([2, 8, 1], 5)
    batch = {k: torch.as_tensor(v)
             for k, v in _burgers_batch(5, 16, 32).items()}
    eager = _eager_burgers()
    hp = {"tf_epochs": 10, "tf_lr": 0.01, "tf_b1": 0.9, "tf_eps": None,
          "nt_epochs": 10, "nt_lr": 1.0, "nt_ncorr": 5,
          "nt_line_search": "armijo", "log_frequency": 100}
    single = Trainer(eager, params_from_numpy(pairs, "cpu"), dict(batch),
                     hp).fit()
    sharded = Trainer(data_parallel(eager, mesh8, ("X_f",)),
                      params_from_numpy(pairs, "cpu"), dict(batch), hp,
                      mesh=mesh8).fit()
    for a, b in zip(pcodec.leaves(single), pcodec.leaves(sharded)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The fused DP wrappers (kernels' plain versions) against JAX's
# ---------------------------------------------------------------------------

def test_burgers_loss_dp_matches_jax(mesh8, jax_mesh8):
    pairs = _pairs([2, 16, 16, 1], 2)
    batch = _burgers_batch(2, 16, 64)
    dp = fused_train.make_burgers_loss_dp(LB, UB, NU, mesh8)
    val, grads = _torch_value_and_grad(dp, pairs, batch)
    jdp = pallas_train.make_burgers_loss_dp(LB, UB, NU, jax_mesh8,
                                            interpret=True)
    jval, jgrads = _jax_value_and_grad(
        jdp, pairs, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(val), jval, rtol=1e-5)
    _assert_grads(grads, jgrads, rtol=5e-4, scale=5e-6)

    # Fixed order: bitwise on a second call, and the loss-only pass
    # (torch.no_grad) gives the same value.
    again, grads2 = _torch_value_and_grad(dp, pairs, batch)
    assert torch.equal(val, again)
    assert all(np.array_equal(a, b) for a, b in zip(grads, grads2))
    params = params_from_numpy(pairs, "cpu")
    with torch.no_grad():
        nograd = dp(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(nograd), float(val), rtol=1e-6)

    whole, _ = _torch_value_and_grad(fused_train.make_burgers_loss(LB, UB, NU),
                                     pairs, batch)
    np.testing.assert_allclose(float(val), float(whole), rtol=1e-6)

    with pytest.raises(ValueError, match="must divide the mesh 'data' axis"):
        _torch_value_and_grad(dp, pairs, _burgers_batch(2, 16, 60))


def test_schrodinger_loss_dp_matches_jax(mesh8, jax_mesh8):
    pairs = _pairs([2, 16, 16, 2], 3)
    batch = _schrodinger_batch(3, 8, 64)
    dp = fused_schrodinger.make_schrodinger_loss_dp(SLB, SUB, mesh8)
    val, grads = _torch_value_and_grad(dp, pairs, batch)
    jdp = pallas_schrodinger.make_schrodinger_loss_dp(SLB, SUB, jax_mesh8,
                                                      interpret=True)
    jval, jgrads = _jax_value_and_grad(
        jdp, pairs, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(val), jval, rtol=1e-5)
    _assert_grads(grads, jgrads, rtol=5e-4, scale=5e-6)

    again, grads2 = _torch_value_and_grad(dp, pairs, batch)
    assert torch.equal(val, again)
    assert all(np.array_equal(a, b) for a, b in zip(grads, grads2))
    with pytest.raises(ValueError, match="must divide the mesh 'data' axis"):
        _torch_value_and_grad(dp, pairs, _schrodinger_batch(3, 8, 36))


# ---------------------------------------------------------------------------
# tpu_mesh in the experiments, end to end against JAX's runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_exps():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import inf_cont_burgers
    import inf_cont_schrodinger
    return inf_cont_burgers, inf_cont_schrodinger


def _ckpt(tmp_path, layers, dtype):
    path = str(tmp_path / "init.npz")
    jax_checkpoint.save_npz(path, jax_mlp.init_mlp(jax.random.PRNGKey(3),
                                                   layers, dtype))
    return path


def _jax_final_loss(res):
    return float(res["loss_fn"](res["params"], res["batch"]))


BURGERS_HP = {"N_u": 50, "N_f": 100, "layers": [2, 20, 20, 1],
              "tf_epochs": 6, "nt_epochs": 6, "log_frequency": 100,
              "tpu_mesh": 8}
SCHRODINGER_HP = {"N_f": 100, "layers": [2, 20, 20, 2], "tf_epochs": 4,
                  "nt_epochs": 4, "log_frequency": 100, "tpu_mesh": 8}


@pytest.mark.parametrize("which", ["burgers", "schrodinger"])
def test_float64_mesh_run_matches_jax(which, jax_exps, tmp_path):
    """N_f = 100 pads to 104 over 8 shards on both sides."""
    jax_mod = jax_exps[0] if which == "burgers" else jax_exps[1]
    mod = torch_burgers_exp if which == "burgers" else torch_schr_exp
    base = BURGERS_HP if which == "burgers" else SCHRODINGER_HP
    hp = {**base, "dtype": "float64",
          "init_checkpoint": _ckpt(tmp_path, base["layers"], jnp.float64)}
    want = jax_mod.run(dict(hp))
    got = mod.run({**hp, "device": "cpu"})
    assert got["batch"]["X_f"].shape[0] == 104
    np.testing.assert_allclose(got["loss"], _jax_final_loss(want), rtol=1e-6)


def test_float32_schrodinger_mesh_run_matches_jax(jax_exps, tmp_path):
    hp = {**SCHRODINGER_HP,
          "init_checkpoint": _ckpt(tmp_path, SCHRODINGER_HP["layers"],
                                   jnp.float32)}
    want = jax_exps[1].run(dict(hp))
    got = torch_schr_exp.run({**hp, "device": "cpu"})
    np.testing.assert_allclose(got["error"], want["error"], rtol=5e-2)


def test_fused_dp_run_with_resample_matches_jax(jax_exps, tmp_path):
    """The fused DP path through Adam + L-BFGS across a collocation
    resample (tests/test_parallel.py:217-237), and the eager mesh path
    resampling an N_f that 8 does not divide (each draw padded)."""
    hp = {**BURGERS_HP, "N_f": 1024, "tf_resample": 4, "tf_epochs": 8,
          "init_checkpoint": _ckpt(tmp_path, BURGERS_HP["layers"],
                                   jnp.float32)}
    want = jax_exps[0].run({**hp, "fused_residual": True})
    got = torch_burgers_exp.run({**hp, "fused_residual": True,
                                 "device": "cpu"})
    assert got["batch"]["X_f"].shape[0] == 1024
    np.testing.assert_allclose(got["error"], want["error"], rtol=5e-2)

    want = jax_exps[0].run({**hp, "N_f": 1001})
    got = torch_burgers_exp.run({**hp, "N_f": 1001, "device": "cpu"})
    assert got["batch"]["X_f"].shape[0] == 1008
    np.testing.assert_allclose(got["error"], want["error"], rtol=5e-2)


@pytest.mark.parametrize("name", [
    "ide_cont_burgers", "inf_disc_burgers", "ide_disc_burgers",
    "inf_disc_allencahn", "ide_disc_kdv", "ide_cont_navierstokes"])
def test_other_experiments_refuse_tpu_mesh(name):
    import importlib
    mod = importlib.import_module(f"pinn_torch.experiments.{name}")
    with pytest.raises(ValueError, match="tpu_mesh"):
        mod.run({"tpu_mesh": True, "device": "cpu", "tf_epochs": 1,
                 "nt_epochs": 1})
