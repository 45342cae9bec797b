"""The port's tensor parallelism (``make_mesh_2d``, ``shard_params_tp``,
``pinn_torch.parallel.tp`` and its forwards, TP+DP in ``data_parallel``)
against the JAX package's GSPMD runs on the eight virtual CPU devices of
tests/conftest.py, the port's mesh being ``["cpu"] * 8`` as 4 x 2.

Bars:
- the placement: each layer's (W, b) spec equal to the
  ``PartitionSpec`` of JAX's ``shard_params_tp``;
- the Burgers continuous loss on JAX's ``_setup`` (tests/test_parallel.py
  :21-37) against JAX's TP run: loss rtol 1e-6, gradients rtol 2e-5
  with atol 1e-7 (tests/test_parallel.py:129-150); one TP+DP Adam step
  against JAX's (tests/test_parallel.py:152-172): parameters rtol 1e-6,
  atol 1e-8;
- Burgers, Schrödinger, KdV (order 3) and Navier–Stokes in float64
  against the port's unsharded loss: rtol 1e-12, gradients rtol 1e-10;
- a TP ``Trainer`` run (6 Adam + 6 L-BFGS) within rtol 5e-5, atol 1e-7
  of the unsharded run (tests/test_parallel.py:122-126);
- every sum of the TP layer and the DP fold has a fixed order, so two
  calls are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pinn.parallel import make_mesh_2d as jax_make_mesh_2d
from pinn.parallel import shard_params_tp as jax_shard_params_tp
from pinn.parallel import shard_points as jax_shard_points
from pinn_torch import graft_entry
from pinn_torch import params as pcodec
from pinn_torch.models import mlp
from pinn_torch.parallel import (MODEL_AXIS, data_parallel, make_mesh_2d,
                                 shard_params_tp)
from pinn_torch.parallel.mesh import TPParams
from pinn_torch.problems import burgers, kdv, navierstokes, schrodinger
from pinn_torch.train import Trainer
from pinn_torch.utils import checkpoint
from pinn_torch.utils.checkpoint import params_from_numpy
from test_parallel import _setup as jax_setup

torch.set_num_threads(1)

NU = 0.01 / np.pi
KEYS = ("X_u", "u", "X_f")


@pytest.fixture(scope="module")
def mesh42():
    return make_mesh_2d(4, 2, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh42():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    return jax_make_mesh_2d(4, 2)


def _pairs(layers, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    return [((rng.randn(a, b) * np.sqrt(2.0 / (a + b))).astype(dtype),
             (0.1 * rng.randn(b)).astype(dtype))
            for a, b in zip(layers[:-1], layers[1:])]


def _value_and_grad(loss_fn, params, batch):
    leaves = [a.detach().clone().requires_grad_(True)
              for a in pcodec.leaves(params)]
    val = loss_fn(pcodec.rebuild(params, leaves), batch)
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    return val.detach(), [torch.zeros_like(a) if g is None else g
                          for a, g in zip(leaves, grads)]


def _burgers(dtype=torch.float32):
    """JAX's ``_setup`` on both sides: (JAX params, batch, loss; the
    port's params, batch, loss)."""
    jparams, jbatch, jloss = jax_setup()
    params = params_from_numpy([(np.asarray(w), np.asarray(b))
                                for w, b in jparams], "cpu", dtype)
    batch = {k: torch.as_tensor(np.array(v), dtype=dtype)
             for k, v in jbatch.items()}
    lb = torch.tensor([-1.0, 0.0], dtype=dtype)
    ub = torch.tensor([1.0, 1.0], dtype=dtype)

    def loss(p, b):
        return burgers.loss_cont_inference(p, b["X_u"], b["u"], b["X_f"],
                                           lb, ub, NU)
    return (jparams, jbatch, jloss), (params, batch, loss)


# ---------------------------------------------------------------------------
# The mesh and the placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [
    [2, 16, 16, 1], [2] + [20] * 8 + [1], [2] + [100] * 4 + [2],
    [3] + [40] * 8 + [2], [1] + [50] * 3 + [50], [1] + [200] * 4 + [101]])
def test_placement_matches_jax(layers, mesh42, jax_mesh42):
    pairs = _pairs(layers, len(layers), np.float32)
    got = shard_params_tp(params_from_numpy(pairs, "cpu"), mesh42)
    want = jax_shard_params_tp(
        tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs), jax_mesh42)
    assert len(got.specs) == len(want)
    for (w_spec, b_spec), (w, b) in zip(got.specs, want):
        assert w_spec == tuple(w.sharding.spec)
        assert b_spec == tuple(b.sharding.spec)
    for (w, b), (w0, b0) in zip(got, pairs):   # whole logical arrays
        assert np.array_equal(w.numpy(), w0) and np.array_equal(b.numpy(), b0)


def test_tp_params_survive_the_codec(mesh42, tmp_path):
    params = shard_params_tp(params_from_numpy(_pairs([2, 8, 8, 2], 0),
                                               "cpu", torch.float64), mesh42)
    flat, unravel = pcodec.ravel_with_unravel(params)
    for tree in (unravel(flat), pcodec.tree_map(torch.clone, params),
                 burgers.init_ide_params(params).net):
        assert isinstance(tree, TPParams)
        assert tree.specs == params.specs and tree.mesh is mesh42
    path = str(tmp_path / "tp.npz")
    checkpoint.save_npz(path, params)
    loaded, _ = checkpoint.load_npz(path, like=params)
    assert isinstance(loaded, TPParams)
    assert torch.equal(pcodec.ravel(loaded), flat)
    assert [params.kind(l) for l in range(3)] == ["column", "row", "column"]


def test_make_mesh_2d_never_shrinks(monkeypatch):
    """The grid's shape; named devices must fill it; without them the
    first n_data x n_model cards, raising with fewer (JAX takes what it
    has)."""
    mesh = make_mesh_2d(4, 2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, MODEL_AXIS: 2} and mesh.size == 8
    assert mesh.n_data == 4 and len(mesh.grid) == 4
    assert make_mesh_2d(n_model=4, devices=["cpu"] * 8).shape == \
        {"data": 2, MODEL_AXIS: 4}
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh_2d(4, 2, devices=["cpu"] * 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_2d(1, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="never shrinks"):
        make_mesh_2d(2, 2)
    mesh = make_mesh_2d(n_model=2)
    assert mesh.grid == ((torch.device("cuda", 0), torch.device("cuda", 1)),)


# ---------------------------------------------------------------------------
# Burgers against JAX's TP run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", [False, True], ids=["tp", "tp+dp"])
def test_burgers_tp_matches_jax(dp, mesh42, jax_mesh42):
    (jparams, jbatch, jloss), (params, batch, loss) = _burgers()
    jtp = jax_shard_params_tp(jparams, jax_mesh42)
    jtb = {k: jax_shard_points(v, jax_mesh42) for k, v in jbatch.items()}
    want, want_g = jax.jit(jax.value_and_grad(jloss))(jtp, jtb)
    fn = data_parallel(loss, mesh42, KEYS) if dp else loss
    got, grads = _value_and_grad(fn, shard_params_tp(params, mesh42), batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=1e-7)


def test_tp_dp_adam_step_matches_jax(mesh42, jax_mesh42):
    """One Adam step (lr 1e-3) with TP+DP placements, as JAX's
    ``test_tp_train_step_runs_on_2d_mesh`` takes it."""
    (jparams, jbatch, jloss), (params, batch, loss) = _burgers()
    jtp = jax_shard_params_tp(jparams, jax_mesh42)
    jtb = {k: jax_shard_points(v, jax_mesh42) for k, v in jbatch.items()}
    opt = optax.adam(1e-3)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jtp, jtb)
    upd, _ = opt.update(jg, opt.init(jtp), jtp)
    want = optax.apply_updates(jtp, upd)
    got_loss, _, got = graft_entry.adam_step(
        data_parallel(loss, mesh42, KEYS), shard_params_tp(params, mesh42),
        batch)
    assert isinstance(got, TPParams)
    np.testing.assert_allclose(got_loss, float(jl), rtol=1e-6)
    for g, w in zip(pcodec.leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-8)


def test_tp_dp_repeats_bitwise(mesh42):
    _, (params, batch, loss) = _burgers()
    fn = data_parallel(loss, mesh42, KEYS)
    tp = shard_params_tp(params, mesh42)
    (v1, g1), (v2, g2) = (_value_and_grad(fn, tp, batch) for _ in range(2))
    assert torch.equal(v1, v2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    with torch.no_grad():
        assert torch.equal(fn(tp, batch), fn(tp, batch))


# ---------------------------------------------------------------------------
# The other losses, float64, against the port's unsharded loss
# ---------------------------------------------------------------------------

def _rand(seed, n, lb, ub):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(lb + (ub - lb) * rng.rand(n, len(lb)))


def _schrodinger_case():
    lb, ub = np.array([-5.0, 0.0]), np.array([5.0, np.pi / 2])
    rng = np.random.RandomState(3)
    tb = torch.as_tensor(rng.rand(8, 1) * ub[1])
    batch = {"X0": torch.cat([_rand(4, 8, lb[:1], ub[:1]),
                              torch.zeros(8, 1, dtype=torch.float64)], 1),
             "H0": torch.as_tensor(rng.randn(8, 2)),
             "X_lb": torch.cat([torch.full((8, 1), lb[0]), tb], 1),
             "X_ub": torch.cat([torch.full((8, 1), ub[0]), tb], 1),
             "X_f": _rand(5, 32, lb, ub)}
    lb_t, ub_t = torch.as_tensor(lb), torch.as_tensor(ub)

    def loss(p, b):
        return schrodinger.loss(p, b["X0"], b["H0"], b["X_lb"], b["X_ub"],
                                b["X_f"], lb_t, ub_t)
    return [2, 12, 12, 12, 12, 2], loss, batch, ("X_f",), lambda net: net


def _kdv_case():
    q = 8
    lb, ub = np.array([-1.0]), np.array([1.0])
    rng = np.random.RandomState(6)
    batch = {"x_0": _rand(7, 16, lb, ub), "u_0": torch.as_tensor(
        rng.randn(16, 1)), "x_1": _rand(8, 16, lb, ub),
        "u_1": torch.as_tensor(rng.randn(16, 1))}
    alpha = torch.as_tensor(rng.rand(q, q) * 0.1)
    beta = torch.as_tensor(rng.rand(1, q) * 0.1)
    lb_t, ub_t = torch.as_tensor(lb), torch.as_tensor(ub)

    def loss(p, b):
        return kdv.loss_disc_identification(p, b["x_0"], b["u_0"], b["x_1"],
                                            b["u_1"], lb_t, ub_t, 0.6, alpha,
                                            beta)
    return [1, 12, 12, 12, q], loss, batch, ("x_0", "u_0", "x_1", "u_1"), \
        burgers.init_ide_params


def _ns_case():
    lb, ub = np.array([1.0, -2.0, 0.0]), np.array([8.0, 2.0, 20.0])
    rng = np.random.RandomState(9)
    batch = {"X": _rand(10, 32, lb, ub), "u": torch.as_tensor(
        rng.randn(32, 1)), "v": torch.as_tensor(rng.randn(32, 1)),
        "X_f": _rand(11, 16, lb, ub)}
    lb_t, ub_t = torch.as_tensor(lb), torch.as_tensor(ub)

    def loss(p, b):
        return navierstokes.loss_identification(p, b["X"], b["u"], b["v"],
                                                lb_t, ub_t, b["X_f"])

    def ide(net):
        p = navierstokes.init_ide_params(net)
        return p._replace(lambda1=p.lambda1 + 0.9, lambda2=p.lambda2 + 0.01)
    return [3, 8, 8, 8, 8, 2], loss, batch, ("X", "u", "v", "X_f"), ide


def _burgers_case():
    lb, ub = np.array([-1.0, 0.0]), np.array([1.0, 1.0])
    rng = np.random.RandomState(12)
    batch = {"X_u": _rand(13, 16, lb, ub), "u": torch.as_tensor(
        rng.rand(16, 1)), "X_f": _rand(14, 64, lb, ub)}
    lb_t, ub_t = torch.as_tensor(lb), torch.as_tensor(ub)

    def loss(p, b):
        return burgers.loss_cont_inference(p, b["X_u"], b["u"], b["X_f"],
                                           lb_t, ub_t, NU)
    return [2, 16, 16, 1], loss, batch, KEYS, lambda net: net


@pytest.mark.parametrize("case", [_burgers_case, _schrodinger_case,
                                  _kdv_case, _ns_case],
                         ids=["burgers", "schrodinger", "kdv", "ns"])
def test_float64_tp_matches_unsharded(case, mesh42):
    """TP alone, and TP+DP over the four data rows (KdV's loss is a sum
    over both snapshots, not a mean: each row's loss is scaled by the
    row count, 4, which is exact)."""
    layers, loss, batch, keys, wrap = case()
    net = params_from_numpy(_pairs(layers, len(layers)), "cpu",
                            torch.float64)
    want, want_g = _value_and_grad(loss, wrap(net), batch)
    tp = wrap(shard_params_tp(net, mesh42))
    scale = 4.0 if case is _kdv_case else 1.0
    fns = [loss, data_parallel(lambda p, b: scale * loss(p, b), mesh42, keys)]
    for fn in fns:
        got, grads = _value_and_grad(fn, tp, batch)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
        for g, w in zip(grads, want_g):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                       atol=1e-13)


def test_forwards_match_unsharded_on_split_head(mesh42):
    """The width-2 head is column-split (as on Schrödinger [2, 100x4, 2])
    and gathered in shard order; orders 1-3, with and without v2."""
    layers = [2, 12, 12, 12, 12, 2]
    net = params_from_numpy(_pairs(layers, 1), "cpu", torch.float64)
    tp = shard_params_tp(net, mesh42)
    assert tp.kind(len(layers) - 2) == "column"
    X = _rand(2, 20, np.zeros(2), np.ones(2))
    lb, ub = torch.zeros(2, dtype=torch.float64), torch.ones(2,
                                                           dtype=torch.float64)
    v1, v2 = torch.tensor([1.0, 0.0], dtype=torch.float64), \
        torch.tensor([0.0, 1.0], dtype=torch.float64)
    np.testing.assert_allclose(mlp.apply(tp, X, lb, ub).numpy(),
                               mlp.apply(net, X, lb, ub).numpy(), rtol=1e-12)
    for order in (1, 2, 3):
        for w2 in (None, v2):
            got = mlp.taylor_apply(tp, X, lb, ub, v1, w2, order)
            want = mlp.taylor_apply(net, X, lb, ub, v1, w2, order)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    np.testing.assert_allclose(g.numpy(), w.numpy(),
                                               rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# The Trainer and the dry run
# ---------------------------------------------------------------------------

def test_tp_trainer_matches_unsharded(mesh42):
    """6 Adam + 6 L-BFGS steps (Armijo) on TP params over the 4 x 2 mesh
    against the same run unsharded."""
    hp = {"tf_epochs": 6, "tf_lr": 0.01, "tf_b1": 0.9, "tf_eps": None,
          "nt_epochs": 6, "nt_lr": 1.0, "nt_ncorr": 5,
          "nt_line_search": "armijo", "log_frequency": 100}
    _, (params, batch, loss) = _burgers()
    want = Trainer(loss, params, batch, hp).fit()
    trainer = Trainer(data_parallel(loss, mesh42, KEYS),
                      shard_params_tp(params, mesh42), batch, hp, mesh=mesh42)
    got = trainer.fit()
    assert isinstance(got, TPParams) and trainer.timing["lbfgs_iters"] > 0
    for g, w in zip(pcodec.leaves(got), pcodec.leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-5, atol=1e-7)


def test_dryrun_multichip_tp_leg(capsys):
    graft_entry.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "TP+DP (4x2 mesh) train step OK" in out
    assert "eager DP (8 shards) train step OK" in out
    assert out.count("MULTIHOST OK") == 2
