"""Schrödinger inference on the port against the JAX package: the eager
residual and loss terms (float64, rtol 1e-10), the fused residual SSE
on the CPU (its kernels' plain version, through the same prep and
reassembly as the CUDA kernels) against
``make_schrodinger_sse(interpret=True)``, the fused full loss, and
``inf_cont_schrodinger.run`` end to end from one JAX-saved init.

Fused bars are those of tests/test_pallas_schrodinger.py: loss rtol
1e-5, gradients rtol 5e-4 with atol 5e-6 * max|g|; the fused run is
held to rtol 1e-3.  bf16 streams are held to the bars of
tests/test_torch_fused_train.py (loss rtol 2e-3, gradient rel-L2 1e-2,
cosine 0.9999 against the JAX bf16 kernel; the reference's bar against
float32); the bf16-warmup run's logged losses to rtol 1e-2 and its
error to rtol 5e-2.
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
from pinn.ops import pallas_schrodinger
from pinn.problems import schrodinger as jax_schrodinger
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch.experiments import inf_cont_schrodinger as torch_exp
from pinn_torch.models import mlp
from pinn_torch.ops import fused_schrodinger
from pinn_torch.problems import schrodinger
from pinn_torch.utils.checkpoint import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

LB = np.array([-5.0, 0.0], np.float32)
UB = np.array([5.0, np.pi / 2], np.float32)


def _pairs(layers, seed, dtype):
    rng = np.random.RandomState(seed)
    return [((rng.randn(a, b) * np.sqrt(2.0 / (a + b))).astype(dtype),
             (0.1 * rng.randn(b)).astype(dtype))
            for a, b in zip(layers[:-1], layers[1:])]


def _batch(seed, dtype, n0=20, nb=15, nf=200):
    rng = np.random.RandomState(seed)
    x0 = LB[0] + (UB[0] - LB[0]) * rng.rand(n0, 1)
    tb = rng.rand(nb, 1) * (UB[1] - LB[1])
    b = {"X0": np.hstack([x0, np.zeros((n0, 1))]), "H0": rng.randn(n0, 2),
         "X_lb": np.hstack([np.full((nb, 1), LB[0]), tb]),
         "X_ub": np.hstack([np.full((nb, 1), UB[0]), tb]),
         "X_f": LB + (UB - LB) * rng.rand(nf, 2)}
    return {k: v.astype(dtype) for k, v in b.items()}


def _grad_leaves(pairs, dtype):
    tp = params_from_numpy(pairs, "cpu", dtype)
    for w, b in tp:
        w.requires_grad_(True)
        b.requires_grad_(True)
    return tp, [a for wb in tp for a in wb]


def _assert_grads(got, want, rtol, atol_rel):
    gmax = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_rel * gmax)


def test_residual_matches_jax():
    pairs = _pairs([2, 20, 20, 2], 0, np.float64)
    X_f = _batch(0, np.float64)["X_f"]
    lb, ub = LB.astype(np.float64), UB.astype(np.float64)
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    want = jax_schrodinger.residual(jp, jnp.asarray(X_f), lb, ub)
    tp = params_from_numpy(pairs, "cpu", torch.float64)
    got = schrodinger.residual(tp, torch.as_tensor(X_f), torch.as_tensor(lb),
                               torch.as_tensor(ub))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("term", ["ic_bc", "loss"])
def test_terms_and_grads_match_jax(term):
    """ic_bc_terms (the periodic term runs taylor_apply at order 1
    without v2) and the whole loss, value and gradients, in float64."""
    pairs = _pairs([2, 20, 20, 2], 1, np.float64)
    b = _batch(1, np.float64)
    lb, ub = LB.astype(np.float64), UB.astype(np.float64)

    def jfun(p):
        if term == "ic_bc":
            m0, mb = jax_schrodinger.ic_bc_terms(
                p, *(jnp.asarray(b[k]) for k in ("X0", "H0", "X_lb", "X_ub")),
                lb, ub)
            return m0 + 2.0 * mb
        return jax_schrodinger.loss(p, *(jnp.asarray(b[k]) for k in
                                         ("X0", "H0", "X_lb", "X_ub", "X_f")),
                                    lb, ub)

    jp = tuple((jnp.asarray(w), jnp.asarray(bb)) for w, bb in pairs)
    want, want_g = jax.value_and_grad(jfun)(jp)

    tp, leaves = _grad_leaves(pairs, torch.float64)
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    lb_t, ub_t = torch.as_tensor(lb), torch.as_tensor(ub)
    if term == "ic_bc":
        m0, mb = schrodinger.ic_bc_terms(tp, tb["X0"], tb["H0"], tb["X_lb"],
                                         tb["X_ub"], lb_t, ub_t)
        got = m0 + 2.0 * mb
    else:
        got = schrodinger.loss(tp, tb["X0"], tb["H0"], tb["X_lb"], tb["X_ub"],
                               tb["X_f"], lb_t, ub_t)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    _assert_grads([g.numpy() for g in grads],
                  [np.asarray(a) for a in jax.tree_util.tree_leaves(want_g)],
                  1e-10, 1e-12)


def test_taylor_order1_without_v2():
    """The periodic-boundary path: value and d1 only, d11 and d2 None."""
    pairs = _pairs([2, 20, 20, 2], 2, np.float64)
    X = _batch(2, np.float64)["X_lb"]
    lb, ub = LB.astype(np.float64), UB.astype(np.float64)
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    want = jax_mlp.taylor_apply(jp, jnp.asarray(X), lb, ub,
                                jnp.array([1.0, 0.0]), order=1)
    got = mlp.taylor_apply(params_from_numpy(pairs, "cpu", torch.float64),
                           torch.as_tensor(X), torch.as_tensor(lb),
                           torch.as_tensor(ub), torch.tensor([1.0, 0.0],
                                                             dtype=torch.float64),
                           order=1)
    assert got.d11 is None and got.d2 is None
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got.d1.numpy(), np.asarray(want.d1),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("layers,n", [([2, 32, 2], 512),
                                      ([2, 40, 40, 2], 300),
                                      ([2, 100, 100, 100, 100, 2], 300),
                                      ([2, 128, 128, 2], 33),
                                      ([2, 100, 2], 1)])
def test_fused_sse_matches_jax(layers, n):
    pairs = _pairs(layers, n, np.float32)
    X_f = (LB + (UB - LB) * np.random.RandomState(n).rand(n, 2)).astype(np.float32)
    jsse = pallas_schrodinger.make_schrodinger_sse(LB, UB, interpret=True)
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    want, want_g = jax.value_and_grad(jsse)(jp, jnp.asarray(X_f))

    tp, leaves = _grad_leaves(pairs, torch.float32)
    sse = fused_schrodinger.make_schrodinger_sse(LB, UB)
    got = sse(tp, torch.as_tensor(X_f))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _assert_grads([g.numpy() for g in grads],
                  [np.asarray(a) for a in jax.tree_util.tree_leaves(want_g)],
                  5e-4, 5e-6)
    with torch.no_grad():   # the loss-only branch
        np.testing.assert_allclose(float(sse(tp, torch.as_tensor(X_f))),
                                   float(got.detach()), rtol=1e-6)


@pytest.mark.parametrize("layers,n,stream_dtype", [
    ([2, 100, 100, 100, 100, 2], 600, None),
    ([2, 128, 128, 2], 33, None),
    ([2, 100, 2], 1, None),
    ([2, 32, 2], 512, None),
    # bf16 on two 512-point TPU tiles or more: XLA CPU refuses the BF16
    # dot of a single one.
    ([2, 100, 100, 100, 100, 2], 600, "bfloat16"),
    ([2, 128, 128, 2], 1031, "bfloat16"),
])
def test_fused_sse_loss_only_matches_jax(layers, n, stream_dtype):
    """The loss-only branch (``schrodinger_sse[_bf16]``'s plain version
    on the CPU) against the JAX primal without a gradient, which runs
    ``_sse_fwd_call`` -> ``_fwd_kernel`` in interpret mode: rtol 1e-5
    (float32), 2e-3 (bf16 streams)."""
    pairs = _pairs(layers, n + 11, np.float32)
    X_f = (LB + (UB - LB) * np.random.RandomState(n + 11).rand(n, 2)).astype(np.float32)
    jsse = pallas_schrodinger.make_schrodinger_sse(LB, UB, interpret=True,
                                                   stream_dtype=stream_dtype)
    want = jsse(tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs),
                jnp.asarray(X_f))
    sse = fused_schrodinger.make_schrodinger_sse(LB, UB, stream_dtype)
    with torch.no_grad():
        got = sse(params_from_numpy(pairs, "cpu", torch.float32),
                  torch.as_tensor(X_f))
    np.testing.assert_allclose(float(got), float(want),
                               rtol=2e-3 if stream_dtype else 1e-5)


def test_fused_loss_matches_jax():
    """make_schrodinger_loss, value and gradients, as
    tests/test_pallas_schrodinger.py holds the JAX one to its XLA loss."""
    pairs = _pairs([2, 40, 40, 2], 5, np.float32)
    b = _batch(5, np.float32, nf=512)
    jloss = pallas_schrodinger.make_schrodinger_loss(LB, UB, interpret=True)
    jp = tuple((jnp.asarray(w), jnp.asarray(bb)) for w, bb in pairs)
    want, want_g = jax.value_and_grad(jloss)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})

    tp, leaves = _grad_leaves(pairs, torch.float32)
    loss = fused_schrodinger.make_schrodinger_loss(LB, UB)
    got = loss(tp, {k: torch.as_tensor(v) for k, v in b.items()})
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _assert_grads([g.numpy() for g in grads],
                  [np.asarray(a) for a in jax.tree_util.tree_leaves(want_g)],
                  5e-4, 5e-6)


def test_fused_sse_plain_is_the_eager_residual_in_float64():
    from pinn_torch.ops import fused_train as ft

    pairs = _pairs([2, 16, 16, 2], 6, np.float64)
    X_f = torch.as_tensor(_batch(6, np.float64)["X_f"])
    tp, leaves = _grad_leaves(pairs, torch.float64)
    lb, ub = (torch.as_tensor(a, dtype=torch.float64) for a in (LB, UB))
    scale = 2.0 / (ub - lb)
    zero = torch.zeros((), dtype=torch.float64)
    vx, vt = torch.stack([scale[0], zero]), torch.stack([zero, scale[1]])
    with torch.no_grad():
        z1row, z2row, wt_args = ft._prep(tp, vx, vt)
    val, gwt, gz1, gz2 = fused_schrodinger.schrodinger_sse_grad_plain(
        ft._normalise(X_f, lb, ub), z1row, z2row, wt_args)
    grads = ft._assemble_net_grads(tp, gwt, gz1, gz2, vx, vt)
    f_u, f_v = schrodinger.residual(tp, X_f, lb, ub)
    want = torch.sum(f_u ** 2) + torch.sum(f_v ** 2)
    want_g = torch.autograd.grad(want, leaves)
    torch.testing.assert_close(val, want.detach(), rtol=1e-12, atol=0.0)
    for g, w in zip(grads, want_g):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-13)


def _sse_value_and_grad(pairs, X_f, stream_dtype):
    tp, leaves = _grad_leaves(pairs, torch.float32)
    val = fused_schrodinger.make_schrodinger_sse(LB, UB, stream_dtype)(
        tp, torch.as_tensor(X_f))
    return float(val.detach()), [g.numpy() for g in
                                 torch.autograd.grad(val, leaves)]


def test_fused_sse_refuses_bf16_streams():
    """Once refused, bf16 streams now run: the plain bf16 version
    against make_schrodinger_sse(stream_dtype="bfloat16",
    interpret=True) at the flagship [2, 100x4, 2], N = 512
    (tests/test_pallas_schrodinger.py:108-113)."""
    pairs = _pairs([2, 100, 100, 100, 100, 2], 7, np.float32)
    X_f = _batch(7, np.float32, nf=512)["X_f"]
    jsse = pallas_schrodinger.make_schrodinger_sse(LB, UB, interpret=True,
                                                   stream_dtype="bfloat16")
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    want_val, want_g = jax.value_and_grad(jsse)(jp, jnp.asarray(X_f))
    want_g = [np.asarray(a) for a in jax.tree_util.tree_leaves(want_g)]
    val, grads = _sse_value_and_grad(pairs, X_f, "bfloat16")
    val32, grads32 = _sse_value_and_grad(pairs, X_f, None)
    g, w, o = (np.concatenate([np.ravel(a) for a in x])
               for x in (grads, want_g, grads32))
    np.testing.assert_allclose(val, float(want_val), rtol=2e-3)
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)
    assert g @ w >= 0.9999 * np.linalg.norm(g) * np.linalg.norm(w)
    np.testing.assert_allclose(val, val32, rtol=3e-2)
    assert g @ o > 0.999 * np.linalg.norm(g) * np.linalg.norm(o)
    assert abs(np.linalg.norm(g) / np.linalg.norm(o) - 1) < 0.05


# ---------------------------------------------------------------------------
# The experiment end to end
# ---------------------------------------------------------------------------

HP = {"N_0": 30, "N_b": 30, "N_f": 600, "layers": [2, 40, 40, 2],
      "tf_epochs": 10, "nt_epochs": 10, "log_frequency": 5}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("schrodinger") / "init.npz")
    jax_checkpoint.save_npz(path, jax_mlp.init_mlp(jax.random.PRNGKey(3),
                                                   HP["layers"], jnp.float64))
    return path


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import inf_cont_schrodinger
    return inf_cont_schrodinger


def _jax_final_loss(res):
    return float(res["loss_fn"](res["params"], res["batch"]))


def _extras(path):
    """The epoch_extra strings of a log file, in order."""
    with open(path) as fh:
        return [r["extra"] for r in map(json.loads, fh)
                if r["event"] in ("epoch", "end")]


@pytest.mark.parametrize("extra,rtol_loss,rtol_err", [
    ({"dtype": "float64"}, 1e-6, 1e-5),
    ({"fused_residual": True}, 1e-3, 1e-3),
])
def test_run_matches_jax(ckpt, jax_exp, extra, rtol_loss, rtol_err,
                         tmp_path):
    hp = {**HP, **extra, "init_checkpoint": ckpt}
    want = jax_exp.run({**hp, "log_file": str(tmp_path / "jax.jsonl")})
    got = torch_exp.run({**hp, "device": "cpu",
                         "log_file": str(tmp_path / "port.jsonl")})
    np.testing.assert_allclose(got["loss"], _jax_final_loss(want),
                               rtol=rtol_loss)
    np.testing.assert_allclose(got["error"], want["error"], rtol=rtol_err)
    assert got["h_pred"].shape == want["h_pred"].shape
    # Each log line carries the three loss terms, evaluated where the JAX
    # Trainer evaluates them; in float64 the printed digits agree.
    got_x, want_x = (_extras(tmp_path / f) for f in ("port.jsonl", "jax.jsonl"))
    assert len(got_x) == len(want_x) == 5
    assert all(x.startswith("mse_0 = ") for x in got_x)
    if extra.get("dtype") == "float64":
        assert got_x == want_x


def test_bf16_warmup_run_matches_jax(ckpt, jax_exp, tmp_path):
    """``fused_residual: True, tf_net_dtype: "bfloat16"``: Adam on the
    bf16-stream residual kernel, L-BFGS on the float32 one; the key
    leaves hp before it is logged, in both packages."""
    hp = {**HP, "fused_residual": True, "tf_net_dtype": "bfloat16",
          "init_checkpoint": ckpt}
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
    assert len(got_l) == len(want_l) == 4
    np.testing.assert_allclose(got_l, want_l, rtol=1e-2)
    np.testing.assert_allclose(got["error"], want["error"], rtol=5e-2)
