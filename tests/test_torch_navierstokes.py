"""Navier–Stokes psi–p identification on the port against the JAX
package: the 13 fused streams (float64 rtol 1e-10, float32 rtol 1e-5),
the port's own triple-``jacfwd`` oracle at JAX's bars (rtol 1e-9, atol
1e-11), ``pinn_torch.ops.diff`` against ``pinn/ops/diff.py`` (float64
rtol 1e-12), the loss with its net and lambda gradients with and
without a separate collocation set (float64 rtol 1e-10), a JAX-saved
``NSIdeParams`` npz leaf for leaf, and ``ide_cont_navierstokes.run``
end to end in float64 from one JAX-saved init a case (lambdas, logged
losses, final loss and field errors rtol 1e-6; the training and
collocation batches bit for bit).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from pinn.models import mlp as jax_mlp
from pinn.ops import diff as jax_diff
from pinn.problems import navierstokes as jax_ns
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec
from pinn_torch.experiments import ide_cont_navierstokes as torch_exp
from pinn_torch.models import mlp
from pinn_torch.ops import diff
from pinn_torch.problems import navierstokes as ns
from pinn_torch.utils.checkpoint import (load_npz, ns_ide_params_from_numpy,
                                         params_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

LB = np.array([0.0, 0.0, 0.0])
UB = np.array([2 * np.pi, 2 * np.pi, 2.0])
ARCHS = [[3, 9, 7, 2], [3, 20, 20, 20, 20, 2], [3, 2]]
DTYPES = {"float64": (jnp.float64, torch.float64),
          "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import ide_cont_navierstokes
    return ide_cont_navierstokes


def _net(layers, seed, dtype):
    """A JAX net and the port's copy of it."""
    jdt, tdt = DTYPES[dtype]
    net = jax_mlp.init_mlp(jax.random.PRNGKey(seed), layers, jdt)
    pairs = [(np.asarray(w), np.asarray(b)) for w, b in net]
    return net, params_from_numpy(pairs, "cpu", tdt)


def _points(n, seed, dtype="float64"):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3) * [6.0, 6.0, 2.0]).astype(dtype)


def _box(dtype):
    return ([jnp.asarray(a, DTYPES[dtype][0]) for a in (LB, UB)],
            [torch.as_tensor(a, dtype=DTYPES[dtype][1]) for a in (LB, UB)])


@pytest.mark.parametrize("dtype", ["float64", "float32", "bf16 weights"])
@pytest.mark.parametrize("layers", ARCHS, ids=str)
def test_streams_match_jax(layers, dtype):
    """``bf16 weights``: bfloat16 weights against float32 points and
    bounds (the ``tf_net_dtype`` cast), every product and first-layer
    row promoted to float32 as JAX promotes them."""
    bf16 = dtype == "bf16 weights"
    dtype = "float32" if bf16 else dtype
    net, tnet = _net(layers, len(layers), dtype)
    if bf16:
        net = [(w.astype(jnp.bfloat16), b.astype(jnp.bfloat16)) for w, b in net]
        tnet = [(w.bfloat16(), b.bfloat16()) for w, b in tnet]
    X = _points(40, 1, dtype)
    (jlb, jub), (tlb, tub) = _box(dtype)
    want = jax_ns.ns_taylor_apply(net, jnp.asarray(X), jlb, jub)
    got = ns.ns_taylor_apply(tnet, torch.as_tensor(X), tlb, tub)
    assert got._fields == want._fields
    f64 = dtype == "float64"
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == (torch.float64 if f64 else torch.float32), name
        w = np.asarray(w)
        atol = (1e-13 if f64 else 1e-6) * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10 if f64 else 1e-5,
                                   atol=atol, err_msg=name)


def _jet_oracle(params, X, lb, ub):
    """The net's first, second and third derivative tensors at each point
    by nested ``torch.func.jacfwd``."""

    def g(x3):
        return mlp.apply(params, x3[None, :], lb, ub)[0]   # (dout,)

    return (vmap(jacfwd(g))(X), vmap(jacfwd(jacfwd(g)))(X),
            vmap(jacfwd(jacfwd(jacfwd(g))))(X))


@pytest.mark.parametrize("layers", ARCHS, ids=str)
def test_streams_match_nested_jacfwd(layers):
    _, params = _net(layers, 3, "float64")
    _, (lb, ub) = _box("float64")
    X = torch.as_tensor(_points(6, 0))
    s = ns.ns_taylor_apply(params, X, lb, ub)
    j1, j2, j3 = _jet_oracle(params, X, lb, ub)
    want = {"v": mlp.apply(params, X, lb, ub),
            "x": j1[:, :, 0], "y": j1[:, :, 1], "t": j1[:, :, 2],
            "xx": j2[:, :, 0, 0], "xy": j2[:, :, 0, 1], "yy": j2[:, :, 1, 1],
            "xt": j2[:, :, 0, 2], "yt": j2[:, :, 1, 2],
            "xxx": j3[:, :, 0, 0, 0], "xxy": j3[:, :, 0, 0, 1],
            "xyy": j3[:, :, 0, 1, 1], "yyy": j3[:, :, 1, 1, 1]}
    for name, oracle in want.items():
        np.testing.assert_allclose(getattr(s, name).numpy(), oracle.numpy(),
                                   rtol=1e-9, atol=1e-11, err_msg=name)


@pytest.mark.parametrize("v", [[1.0, 0.0, 0.0], [0.3, -0.7, 0.5]], ids=str)
def test_diff_matches_jax(v):
    """The four jvp compositions on one small MLP, float64."""
    net, tnet = _net([3, 12, 12, 2], 9, "float64")
    X = _points(25, 2)
    (jlb, jub), (tlb, tub) = _box("float64")
    jv, tv = jnp.asarray(v), torch.tensor(v, dtype=torch.float64)
    jX, tX = jnp.asarray(X), torch.as_tensor(X)

    def jf(x):
        return jax_mlp.apply(net, x, jlb, jub)

    def tf(x):
        return mlp.apply(tnet, x, tlb, tub)

    vt = [0.0, 0.0, 1.0]
    pairs = [
        (diff.directional(tf, tX, tv), jax_diff.directional(jf, jX, jv)),
        (diff.directional2(tf, tX, tv), jax_diff.directional2(jf, jX, jv)),
        (diff.directional3(tf, tX, tv), jax_diff.directional3(jf, jX, jv)),
        (diff.space_time_derivs(tf, tX, tv, torch.tensor(vt)),
         jax_diff.space_time_derivs(jf, jX, jv, jnp.asarray(vt))),
        (diff.space_time_derivs(tf, tX, tv, order=1),
         jax_diff.space_time_derivs(jf, jX, jv, order=1)),
    ]
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-14)


def _ide_case(layers, l1, l2, seed):
    net, tnet = _net(layers, seed, "float64")
    jp = jax_ns.NSIdeParams(net=net, lambda1=jnp.array([l1]),
                            lambda2=jnp.array([l2]))
    tp = ns.NSIdeParams(net=tnet, lambda1=torch.tensor([l1], dtype=torch.float64),
                        lambda2=torch.tensor([l2], dtype=torch.float64))
    rng = np.random.RandomState(seed)
    arrays = {"X": _points(60, seed), "u": rng.randn(60, 1),
              "v": rng.randn(60, 1), "X_f": _points(90, seed + 1)}
    return jp, tp, arrays


@pytest.mark.parametrize("collocation", [False, True])
@pytest.mark.parametrize("l1,l2", [(0.0, 0.0), (0.9, 0.012)])
def test_loss_identification_matches_jax(l1, l2, collocation):
    """The loss and its net, lambda1 and lambda2 gradients against
    jax.value_and_grad, float64."""
    jp, tp, a = _ide_case([3, 10, 10, 2], l1, l2, 11)
    (jlb, jub), (tlb, tub) = _box("float64")
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    jX_f = jnp.asarray(a["X_f"]) if collocation else None
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_ns.loss_identification(p, a["X"], a["u"], a["v"],
                                             jlb, jub, X_f=jX_f)))(jp)
    leaves = [x.requires_grad_(True) for x in pcodec.leaves(tp)]
    got = ns.loss_identification(tp, t["X"], t["u"], t["v"], tlb, tub,
                                 X_f=t["X_f"] if collocation else None)
    # The output bias reaches only p's value, which no term reads: its
    # gradient is zero (JAX) or unused (autograd).
    grads = torch.autograd.grad(got, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    want_g = [np.asarray(w) for w in jax.tree_util.tree_leaves(want_g)]
    assert [tuple(g.shape) for g in grads] == [w.shape for w in want_g]
    gmax = max(float(np.abs(w).max()) for w in want_g)
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-13 * gmax)


def test_collocation_at_the_data_points_is_the_data_loss():
    _, tp, a = _ide_case([3, 10, 10, 2], 0.9, 0.012, 4)
    _, (lb, ub) = _box("float64")
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    plain = ns.loss_identification(tp, t["X"], t["u"], t["v"], lb, ub)
    same = ns.loss_identification(tp, t["X"], t["u"], t["v"], lb, ub,
                                  X_f=t["X"])
    assert float(same) == float(plain)


def test_jax_saved_ns_params_load_leaf_for_leaf(tmp_path):
    jp, tp, _ = _ide_case([3, 10, 10, 2], 0.4, 0.02, 6)
    path = str(tmp_path / "ns.npz")
    jax_checkpoint.save_npz(path, jp)
    like = ns.init_ide_params(mlp.init_mlp([3, 10, 10, 2],
                                           torch.Generator().manual_seed(0),
                                           torch.float64, "cpu"))
    got, _ = load_npz(path, like=like)
    assert type(got) is ns.NSIdeParams
    want = jax.tree_util.tree_leaves(jp)
    assert len(pcodec.leaves(got)) == len(want)
    for g, w in zip(pcodec.leaves(got), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tp2 = ns_ide_params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in jp.net],
        np.asarray(jp.lambda1), np.asarray(jp.lambda2), "cpu", torch.float64)
    for g, w in zip(pcodec.leaves(tp2), pcodec.leaves(tp)):
        assert torch.equal(g, w)


def test_run_refuses_tpu_mesh():
    with pytest.raises(ValueError, match="tpu_mesh"):
        torch_exp.run({"tpu_mesh": True, "device": "cpu"})


def test_df32_requires_float64():
    with pytest.raises(ValueError, match="df32"):
        torch_exp.run({"net_impl": "df32", "device": "cpu"})


# ---------------------------------------------------------------------------
# The experiment end to end, float64 from one JAX-saved init a case
# ---------------------------------------------------------------------------

HP = {"N_u": 200, "layers": [3, 10, 10, 2], "grid_nx": 16, "grid_ny": 16,
      "grid_nt": 5, "tf_epochs": 5, "nt_epochs": 5, "log_frequency": 1,
      "dtype": "float64"}


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


def _recording(monkeypatch, module, out):
    """Record each case's training batch and final loss."""
    base = module.Trainer

    class Recording(base):
        def fit(self):
            params = super().fit()
            out.append(({k: np.asarray(v) for k, v in self.batch.items()},
                        float(self.loss_fn(params, self.batch))))
            return params

    monkeypatch.setattr(module, "Trainer", Recording)


@pytest.mark.parametrize("extra", [
    {},
    {"N_f": 150, "nt_val_every": 2},
    {"dataset": "taylor-green", "grid_nx": 12, "grid_ny": 12},
], ids=["spectral", "collocation+val", "taylor-green"])
def test_float64_run_matches_jax(jax_exp, tmp_path, monkeypatch, extra):
    """Clean and noisy cases, each from its own JAX-saved checkpoint."""
    ckpt = str(tmp_path / "init.npz")
    for i, path in enumerate((ckpt, ckpt.replace(".npz", "-noisy.npz"))):
        net = jax_mlp.init_mlp(jax.random.PRNGKey(31 + i), HP["layers"],
                               jnp.float64)
        jax_checkpoint.save_npz(path, jax_ns.init_ide_params(net))
    hp = {**HP, **extra, "init_checkpoint": ckpt}
    seen = {"jax": [], "port": []}
    _recording(monkeypatch, jax_exp, seen["jax"])
    _recording(monkeypatch, torch_exp, seen["port"])
    want = jax_exp.run({**hp, "log_file": str(tmp_path / "jax.jsonl")},
                       plot=False)
    got = torch_exp.run({**hp, "device": "cpu",
                         "log_file": str(tmp_path / "port.jsonl")})

    (got_hp, got_runs), (want_hp, want_runs) = (
        _logs(tmp_path / f) for f in ("port.jsonl", "jax.jsonl"))
    assert got_hp == want_hp
    assert [len(r) for r in got_runs] == [len(r) for r in want_runs] == [10, 10]
    np.testing.assert_allclose(sum(got_runs, []), sum(want_runs, []),
                               rtol=1e-6)
    for key in ("lambdas", "lambdas_noisy", "error"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    for key in ("u", "v", "p"):
        np.testing.assert_allclose(got["field_errors"][key],
                                   want["field_errors"][key], rtol=1e-6,
                                   err_msg=key)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for (g_batch, g_loss), (w_batch, w_loss) in zip(seen["port"], seen["jax"]):
        assert sorted(g_batch) == sorted(w_batch)
        for k in w_batch:
            np.testing.assert_array_equal(g_batch[k], w_batch[k], err_msg=k)
        np.testing.assert_allclose(g_loss, w_loss, rtol=1e-6)
    assert got["data"].X_star.shape == want["data"].X_star.shape
    assert all(a.dtype == torch.float64 for a in pcodec.leaves(got["params"]))
