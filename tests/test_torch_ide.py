"""Burgers identification on the port against the JAX package: the eager
loss (float64, rtol 1e-10), the fused identification loss on the CPU
(its kernels' plain version, through the same prep and reassembly as
the CUDA kernels) against ``make_burgers_ide_loss(interpret=True)``,
and ``ide_cont_burgers.run`` end to end from one JAX-saved init.

Fused bars are those of tests/test_pallas_train.py: loss rtol 1e-5, net
gradients rtol 5e-4 with atol 5e-6 * max|g|, lambda gradients rtol
1e-4 (float32 summed in another order on each side); the fused run's
lambdas rtol 1e-2 with atol 5e-4.  bf16 streams are held to the bars
of tests/test_torch_fused_train.py (loss rtol 2e-3, gradient rel-L2
1e-2, cosine 0.9999 against the JAX bf16 kernel; the reference's bar
against float32); the bf16 run's logged losses to rtol 1e-2 and its
lambda error to rtol 5e-2.
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
from pinn.ops import pallas_train
from pinn.problems import burgers as jax_burgers
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import params as pcodec
from pinn_torch.experiments import ide_cont_burgers as torch_exp
from pinn_torch.ops import fused_train
from pinn_torch.problems import burgers
from pinn_torch.utils.checkpoint import ide_params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)
LAMBDA_PAIRS = [(0.0, -6.0), (1.3, -4.0)]


def _jax_params(layers, l1, logl2, dtype, seed):
    net = jax_mlp.init_mlp(jax.random.PRNGKey(seed), layers, dtype)
    return jax_burgers.IdeParams(net=net, lambda1=jnp.array([l1], dtype),
                                 log_lambda2=jnp.array([logl2], dtype))


def _torch_params(jp, dtype):
    tp = ide_params_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp.net],
                               np.asarray(jp.lambda1), np.asarray(jp.log_lambda2),
                               "cpu", dtype)
    for a in pcodec.leaves(tp):
        a.requires_grad_(True)
    return tp


def _points(n, seed, dtype):
    rng = np.random.RandomState(seed)
    X = (LB + (UB - LB) * rng.rand(n, 2)).astype(dtype)
    u = rng.randn(n, 1).astype(dtype)
    return X, u


@pytest.mark.parametrize("l1,logl2", LAMBDA_PAIRS)
def test_loss_cont_identification_matches_jax(l1, logl2):
    jp = _jax_params([2, 20, 20, 20, 1], l1, logl2, jnp.float64, seed=0)
    X, u = _points(150, 0, np.float64)
    lb, ub = LB.astype(np.float64), UB.astype(np.float64)
    want, want_g = jax.value_and_grad(
        lambda p: jax_burgers.loss_cont_identification(
            p, jnp.asarray(X), jnp.asarray(u), lb, ub))(jp)

    tp = _torch_params(jp, torch.float64)
    got = burgers.loss_cont_identification(
        tp, torch.as_tensor(X), torch.as_tensor(u), torch.as_tensor(lb),
        torch.as_tensor(ub))
    grads = torch.autograd.grad(got, pcodec.leaves(tp))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-10)
    for g, wg in zip(grads, jax.tree_util.tree_leaves(want_g)):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg, rtol=1e-10,
                                   atol=1e-12 * np.abs(wg).max())


@pytest.mark.parametrize("layers,n", [([2, 20, 20, 20, 1], 300),
                                      ([2, 16, 1], 1024)])
@pytest.mark.parametrize("l1,logl2", LAMBDA_PAIRS)
def test_fused_ide_loss_matches_jax(layers, n, l1, logl2):
    jp = _jax_params(layers, l1, logl2, jnp.float32, seed=n)
    X, u = _points(n, n, np.float32)
    jloss = pallas_train.make_burgers_ide_loss(LB, UB, interpret=True)
    want, want_g = jax.value_and_grad(jloss)(
        jp, {"X_u": jnp.asarray(X), "u": jnp.asarray(u)})
    want_g = [np.asarray(a) for a in jax.tree_util.tree_leaves(want_g)]

    tp = _torch_params(jp, torch.float32)
    loss = fused_train.make_burgers_ide_loss(LB, UB)
    batch = {"X_u": torch.as_tensor(X), "u": torch.as_tensor(u)}
    got = loss(tp, batch)
    grads = [g.numpy() for g in torch.autograd.grad(got, pcodec.leaves(tp))]

    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    gmax = max(float(np.abs(w).max()) for w in want_g[:-2])
    for g, w in zip(grads[:-2], want_g[:-2]):
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-6 * gmax)
    for g, w in zip(grads[-2:], want_g[-2:]):   # lambda1, log_lambda2
        np.testing.assert_allclose(g, w, rtol=1e-4)

    # torch.no_grad() takes the loss-only branch: the same value
    with torch.no_grad():
        v_nograd = float(loss(tp, batch))
    np.testing.assert_allclose(v_nograd, float(got.detach()), rtol=1e-6)


def test_fused_ide_plain_is_the_eager_loss_in_float64():
    """The plain version through prep and reassembly, in float64, is
    loss_cont_identification and its autograd, lambdas included."""
    jp = _jax_params([2, 12, 12, 1], 0.8, -3.0, jnp.float64, seed=4)
    X, u = _points(70, 4, np.float64)
    tp = _torch_params(jp, torch.float64)
    lb, ub = (torch.as_tensor(a, dtype=torch.float64) for a in (LB, UB))
    lb_, ub_, vx, vt = fused_train._tangents(LB, UB, "cpu")
    vx, vt = vx.double(), vt.double()
    tb = {"X_u": torch.as_tensor(X), "u": torch.as_tensor(u)}
    a0, aux = fused_train._prep_ide_points(tb, lb, ub)
    with torch.no_grad():
        lam = fused_train._lam(tp.lambda1, tp.log_lambda2)
        z1row, z2row, wt_args = fused_train._prep(tp.net, vx, vt)
    val, gwt, gz1, gz2, glam = fused_train.burgers_ide_loss_grad_plain(
        a0, aux, lam, z1row, z2row, wt_args)
    grads = fused_train._assemble_net_grads(tp.net, gwt, gz1, gz2, vx, vt)
    grads += [glam[0:1], -glam[1:2] * lam[1:2]]

    want = burgers.loss_cont_identification(tp, tb["X_u"], tb["u"], lb, ub)
    want_g = torch.autograd.grad(want, pcodec.leaves(tp))
    torch.testing.assert_close(val, want.detach(), rtol=1e-12, atol=0.0)
    for g, w in zip(grads, want_g):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-14)


def _fused_value_and_grad(jp, X, u, stream_dtype):
    """The port's fused identification loss and its gradients (net
    leaves, then lambda1, log lambda2) as numpy."""
    tp = _torch_params(jp, torch.float32)
    val = fused_train.make_burgers_ide_loss(LB, UB, stream_dtype)(
        tp, {"X_u": torch.as_tensor(X), "u": torch.as_tensor(u)})
    grads = torch.autograd.grad(val, pcodec.leaves(tp))
    return float(val.detach()), [g.numpy() for g in grads]


def _assert_bf16_parity(val, grads, want_val, want_grads, val32, grads32):
    g, w, o = (np.concatenate([np.ravel(a) for a in x])
               for x in (grads, want_grads, grads32))
    np.testing.assert_allclose(val, want_val, rtol=2e-3)
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)
    assert g @ w >= 0.9999 * np.linalg.norm(g) * np.linalg.norm(w)
    np.testing.assert_allclose(val, val32, rtol=3e-2)
    assert g @ o > 0.999 * np.linalg.norm(g) * np.linalg.norm(o)
    assert abs(np.linalg.norm(g) / np.linalg.norm(o) - 1) < 0.05


@pytest.mark.parametrize("stream_dtype,n,l1,logl2", [
    (None, 33, 0.0, -6.0),
    (None, 33, 1.3, -4.0),
    ("bfloat16", 1031, 1.3, -4.0),
])
def test_fused_ide_edge_widths_match_jax(stream_dtype, n, l1, logl2):
    """[2, 7, 33, 64, 1]: hidden widths that are not multiples of 4 and
    the widest the CUDA kernels take, as in their card tests; N = 33 is a
    tile and one point.  The plain version against the JAX kernel in
    interpret mode at the module's bars; bf16 at N = 1,031, two of the
    JAX kernel's tiles (one fails on XLA's CPU backend)."""
    jp = _jax_params([2, 7, 33, 64, 1], l1, logl2, jnp.float32, seed=n)
    X, u = _points(n, n, np.float32)
    jloss = pallas_train.make_burgers_ide_loss(LB, UB, interpret=True,
                                               stream_dtype=stream_dtype)
    want, want_g = jax.value_and_grad(jloss)(
        jp, {"X_u": jnp.asarray(X), "u": jnp.asarray(u)})
    want_g = [np.asarray(a) for a in jax.tree_util.tree_leaves(want_g)]
    val, grads = _fused_value_and_grad(jp, X, u, stream_dtype)
    if stream_dtype is not None:
        val32, grads32 = _fused_value_and_grad(jp, X, u, None)
        _assert_bf16_parity(val, grads, float(want), want_g, val32, grads32)
        return
    np.testing.assert_allclose(val, float(want), rtol=1e-5)
    gmax = max(float(np.abs(w).max()) for w in want_g[:-2])
    for g, w in zip(grads[:-2], want_g[:-2]):
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-6 * gmax)
    for g, w in zip(grads[-2:], want_g[-2:]):   # lambda1, log_lambda2
        np.testing.assert_allclose(g, w, rtol=1e-4)


@pytest.mark.parametrize("layers,n,stream_dtype", [
    ([2] + [20] * 8 + [1], 33, None),      # a tile and one point
    ([2, 7, 33, 64, 1], 100, None),        # widths off 4, the widest layer
    ([2] + [20] * 15 + [1], 64, None),     # the most hidden layers
    ([2, 7, 33, 64, 1], 1031, "bfloat16"),  # two JAX tiles (XLA CPU and bf16)
])
def test_fused_ide_loss_only_matches_jax(layers, n, stream_dtype):
    """Under torch.no_grad() the fused identification loss takes the
    loss-only branch (the narrow loss-only kernel's plain version here):
    its value against the JAX primal of make_burgers_ide_loss in
    interpret mode (float32 rtol 1e-5; bf16 streams the module's 2e-3)
    and against the loss+grad branch's value (rtol 1e-6), at the shapes
    where the narrow kernel cuts its work."""
    jp = _jax_params(layers, 1.3, -4.0, jnp.float32, seed=n + 1)
    X, u = _points(n, n + 1, np.float32)
    jloss = pallas_train.make_burgers_ide_loss(LB, UB, interpret=True,
                                               stream_dtype=stream_dtype)
    want = float(jloss(jp, {"X_u": jnp.asarray(X), "u": jnp.asarray(u)}))
    tp = _torch_params(jp, torch.float32)
    loss = fused_train.make_burgers_ide_loss(LB, UB, stream_dtype)
    batch = {"X_u": torch.as_tensor(X), "u": torch.as_tensor(u)}
    with torch.no_grad():
        v_nograd = float(loss(tp, batch))
    np.testing.assert_allclose(v_nograd, want,
                               rtol=1e-5 if stream_dtype is None else 2e-3)
    np.testing.assert_allclose(v_nograd, float(loss(tp, batch).detach()),
                               rtol=1e-6)


def test_fused_ide_refuses_bf16_streams():
    """Once refused, bf16 streams now run: the plain bf16 version
    against make_burgers_ide_loss(stream_dtype="bfloat16",
    interpret=True) at [2, 20, 20, 20, 1], N = 300."""
    jp = _jax_params([2, 20, 20, 20, 1], 1.3, -4.0, jnp.float32, seed=4)
    X, u = _points(300, 4, np.float32)
    jloss = pallas_train.make_burgers_ide_loss(LB, UB, interpret=True,
                                               stream_dtype="bfloat16")
    want_val, want_g = jax.value_and_grad(jloss)(
        jp, {"X_u": jnp.asarray(X), "u": jnp.asarray(u)})
    want_g = [np.asarray(a) for a in jax.tree_util.tree_leaves(want_g)]
    val, grads = _fused_value_and_grad(jp, X, u, "bfloat16")
    val32, grads32 = _fused_value_and_grad(jp, X, u, None)
    _assert_bf16_parity(val, grads, float(want_val), want_g, val32, grads32)


# ---------------------------------------------------------------------------
# The experiment end to end
# ---------------------------------------------------------------------------

HP = {"N_u": 500, "layers": [2, 20, 20, 1], "tf_epochs": 10,
      "nt_epochs": 10, "log_frequency": 5}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """JAX-initialised per-case checkpoints (``init.npz`` for the clean
    case, ``init-noisy.npz`` for the noisy one) both packages load."""
    path = str(tmp_path_factory.mktemp("ide") / "init.npz")
    net = jax_mlp.init_mlp(jax.random.PRNGKey(11), HP["layers"], jnp.float64)
    params = jax_burgers.init_ide_params(net, jnp.float64)
    jax_checkpoint.save_npz(path, params)
    jax_checkpoint.save_npz(path.replace(".npz", "-noisy.npz"), params)
    return path


@pytest.fixture(scope="module")
def jax_exp():
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    import ide_cont_burgers
    return ide_cont_burgers


def test_float64_run_matches_jax(ckpt, jax_exp, tmp_path):
    hp = {**HP, "dtype": "float64", "init_checkpoint": ckpt}
    want = jax_exp.run({**hp, "log_file": str(tmp_path / "jax.jsonl")})
    got = torch_exp.run({**hp, "device": "cpu",
                         "log_file": str(tmp_path / "port.jsonl")})
    np.testing.assert_allclose(got["lambdas"], want["lambdas"], rtol=1e-6)
    np.testing.assert_allclose(got["lambdas_noisy"], want["lambdas_noisy"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["error"], want["error"], rtol=1e-6)
    assert got["u_pred"].shape == want["u_pred"].shape
    # Both cases' log lines carry the lambdas, printed as the JAX run
    # prints them, from the parameters the JAX Trainer logs them with.
    extras = []
    for name in ("port.jsonl", "jax.jsonl"):
        with open(tmp_path / name) as fh:
            extras.append([r["extra"] for r in map(json.loads, fh)
                           if r["event"] in ("epoch", "end")])
    assert len(extras[0]) == 10 and extras[0][0].startswith("l1 = ")
    assert extras[0] == extras[1]


def test_fused_float32_run_matches_jax(ckpt, jax_exp):
    hp = {**HP, "fused_residual": True, "init_checkpoint": ckpt}
    want = jax_exp.run(dict(hp))
    got = torch_exp.run({**hp, "device": "cpu"})
    np.testing.assert_allclose(got["lambdas"], want["lambdas"], rtol=1e-2,
                               atol=5e-4)
    np.testing.assert_allclose(got["lambdas_noisy"], want["lambdas_noisy"],
                               rtol=1e-2, atol=5e-4)


def _epoch_losses(path):
    with open(path) as fh:
        return [r["loss"] for r in map(json.loads, fh) if r["event"] == "epoch"]


def _logged_hp(path):
    with open(path) as fh:
        hp = json.loads(fh.readline())["hp"]
    return {k: v for k, v in hp.items() if k not in ("device", "log_file")}


def test_fused_bf16_run_matches_jax(ckpt, jax_exp, tmp_path):
    """``fused_residual: "bf16"``: both phases on the bf16-stream
    kernels (their plain versions here), clean and noisy cases.  N_u =
    1,100 spans two of the JAX kernel's 1,024-point tiles: with one
    tile, XLA's CPU backend refuses the JAX run's bf16 dot ("Unsupported
    element type for DotThunk::Execute: BF16 x BF16 = F32")."""
    hp = {**HP, "N_u": 1100, "fused_residual": "bf16", "init_checkpoint": ckpt}
    want = jax_exp.run({**hp, "log_file": str(tmp_path / "jax.jsonl")})
    got = torch_exp.run({**hp, "device": "cpu",
                         "log_file": str(tmp_path / "port.jsonl")})
    got_l, want_l = (_epoch_losses(tmp_path / f) for f in ("port.jsonl", "jax.jsonl"))
    assert len(got_l) == len(want_l) == 8
    np.testing.assert_allclose(got_l, want_l, rtol=1e-2)
    np.testing.assert_allclose(got["error"], want["error"], rtol=5e-2)
    assert _logged_hp(tmp_path / "port.jsonl") == _logged_hp(tmp_path / "jax.jsonl")


def test_run_refuses_tf_net_dtype_with_fused_loss():
    """The JAX run of this combination hands float32 network gradients
    back through the bf16 cast (see the experiment's docstring); the
    port refuses it rather than reproduce that mixture."""
    with pytest.raises(NotImplementedError, match="fused_residual"):
        torch_exp.run({**HP, "fused_residual": True,
                       "tf_net_dtype": "bfloat16", "device": "cpu"})


def test_run_refuses_tpu_mesh():
    with pytest.raises(ValueError, match="tpu_mesh"):
        torch_exp.run({**HP, "tpu_mesh": True, "device": "cpu"})
