"""The port's Trainer on the CPU: ``epoch_extra`` strings reach the log
lines, a non-pair parameter structure (IdeParams) trains through both
phases and its checkpoints, and hp["tf_net_dtype"] computes what the JAX
Trainer's cast computes."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.optim.adam import AdamRunner
from pinn.problems import burgers as jax_burgers
from pinn_torch import params as pcodec
from pinn_torch.optim.adam import net_dtype_cast
from pinn_torch.problems import burgers
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger, checkpoint
from pinn_torch.utils.checkpoint import params_from_numpy

torch.set_num_threads(1)


def _problem(seed=0, n=64):
    rng = np.random.RandomState(seed)
    layers = [2, 8, 8, 1]
    net = params_from_numpy([(rng.randn(a, b) * np.sqrt(2.0 / (a + b)),
                              np.zeros(b))
                             for a, b in zip(layers[:-1], layers[1:])],
                            "cpu", torch.float64)
    X = torch.as_tensor(np.stack([rng.uniform(-1, 1, n), rng.rand(n)], 1))
    u = torch.as_tensor(-np.sin(np.pi * X[:, :1].numpy()))
    lb, ub = torch.tensor([-1.0, 0.0], dtype=torch.float64), torch.tensor(
        [1.0, 1.0], dtype=torch.float64)

    def loss_fn(p, b):
        return burgers.loss_cont_identification(p, b["X_u"], b["u"], lb, ub)

    return burgers.init_ide_params(net), {"X_u": X, "u": u}, loss_fn


def test_epoch_extra_reaches_log_lines(tmp_path):
    params0, batch, loss_fn = _problem()
    log_file = str(tmp_path / "log.jsonl")
    hp = {"tf_epochs": 4, "nt_epochs": 4, "log_frequency": 2,
          "tf_lr": 1e-3, "nt_line_search": "armijo", "log_file": log_file}
    lines = []
    calls = []

    def extra(p):
        calls.append(p)
        return f"l1 = {float(p.lambda1[0]):.6f}"

    trainer = Trainer(loss_fn, params0, batch, hp,
                      Logger(hp, print_fn=lines.append, device="cpu"),
                      epoch_extra=extra)
    trainer.fit()
    epoch_lines = [l for l in lines if "_epoch =" in l]
    assert len(epoch_lines) == 4  # Adam 0, 2; L-BFGS 2, 4
    assert all("l1 = " in l for l in epoch_lines)
    assert "l1 = " in [l for l in lines if "Training finished" in l][0]
    with open(log_file) as fh:
        recs = [json.loads(r) for r in fh]
    assert [r["extra"].startswith("l1 = ") for r in recs
            if r["event"] in ("epoch", "end")] == [True] * 5
    assert all(isinstance(p, burgers.IdeParams) for p in calls)


def test_ide_params_train_through_both_phases(tmp_path):
    params0, batch, loss_fn = _problem(seed=1)
    save = str(tmp_path / "ck.npz")
    hp = {"tf_epochs": 6, "nt_epochs": 6, "log_frequency": 3, "tf_lr": 1e-2,
          "nt_line_search": "armijo", "save_checkpoint": save, "save_every": 3,
          "model_description": True}
    lines = []
    trainer = Trainer(loss_fn, params0, batch, hp,
                      Logger(hp, print_fn=lines.append, device="cpu"))
    out = trainer.fit()
    assert isinstance(out, burgers.IdeParams)
    assert any(".log_lambda2: (1,) float64" in l for l in lines)
    assert float(out.lambda1[0]) != 0.0 and float(out.log_lambda2[0]) != -6.0
    with torch.no_grad():
        assert float(loss_fn(out, batch)) < float(loss_fn(params0, batch))
    # the periodic checkpoint holds the final iterate in IdeParams order
    saved, meta = checkpoint.load_npz(save, like=params0)
    assert meta["extra"]["phase"] == "lbfgs"
    np.testing.assert_array_equal(pcodec.ravel(saved).numpy(),
                                  pcodec.ravel(out).numpy())


def _cast_case(problem):
    """(JAX loss, port loss, JAX params, port params, batch as numpy) of
    a small eager problem, float32."""
    rng = np.random.RandomState(8)
    layers = [2, 20, 20, 1]
    pairs = [((rng.randn(a, b) * np.sqrt(2.0 / (a + b))).astype(np.float32),
              (0.1 * rng.randn(b)).astype(np.float32))
             for a, b in zip(layers[:-1], layers[1:])]
    lb, ub = np.array([-1.0, 0.0], np.float32), np.array([1.0, 1.0], np.float32)
    lb_t, ub_t = torch.as_tensor(lb), torch.as_tensor(ub)
    jnet = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in pairs)
    tnet = params_from_numpy(pairs, "cpu", torch.float32)
    if problem == "inference":
        batch = {"X_u": lb + (ub - lb) * rng.rand(32, 2), "u": rng.rand(32, 1),
                 "X_f": lb + (ub - lb) * rng.rand(200, 2)}
        nu = 0.01 / np.pi

        def jloss(p, b):
            return jax_burgers.loss_cont_inference(
                p, b["X_u"], b["u"], b["X_f"], jnp.asarray(lb), jnp.asarray(ub), nu)

        def tloss(p, b):
            return burgers.loss_cont_inference(p, b["X_u"], b["u"], b["X_f"],
                                               lb_t, ub_t, nu)
        jparams, tparams = jnet, tnet
    else:
        batch = {"X_u": lb + (ub - lb) * rng.rand(200, 2), "u": rng.randn(200, 1)}

        def jloss(p, b):
            return jax_burgers.loss_cont_identification(
                p, b["X_u"], b["u"], jnp.asarray(lb), jnp.asarray(ub))

        def tloss(p, b):
            return burgers.loss_cont_identification(p, b["X_u"], b["u"], lb_t, ub_t)
        jparams = jax_burgers.IdeParams(net=jnet, lambda1=jnp.array([0.7], jnp.float32),
                                        log_lambda2=jnp.array([-4.5], jnp.float32))
        tparams = burgers.IdeParams(net=tnet, lambda1=torch.tensor([0.7]),
                                    log_lambda2=torch.tensor([-4.5]))
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    return jloss, tloss, jparams, tparams, batch


@pytest.mark.parametrize("problem", ["inference", "identification"])
def test_tf_net_dtype_cast_matches_jax(problem):
    """hp["tf_net_dtype"] = "bfloat16" around the eager losses: float32
    arithmetic on bf16-rounded parameters and batch (``exp(log
    lambda2)`` in bf16, as JAX computes it), each product's weight
    gradient rounded to bf16 and summed in bf16.  The loss equals the
    JAX Trainer's wrapped loss (AdamRunner.loss_fn) to rtol 1e-6; every
    gradient element is bf16-representable and within one bf16 ulp of
    JAX's."""
    jloss, tloss, jparams, tparams, batch = _cast_case(problem)
    runner = AdamRunner(jloss, {"tf_lr": 1e-3, "tf_net_dtype": "bfloat16"})
    want, want_g = jax.value_and_grad(runner.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    want_g = [np.asarray(a) for a in jax.tree_util.tree_leaves(want_g)]

    leaves = [a.requires_grad_(True) for a in pcodec.leaves(tparams)]
    got = net_dtype_cast(tloss, "bfloat16")(
        tparams, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(got, leaves)
    assert got.dtype == torch.float32 and len(grads) == len(want_g)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for g, w in zip(grads, want_g):
        torch.testing.assert_close(g, g.to(torch.bfloat16).float(), rtol=0,
                                   atol=0)
        ulp = np.spacing(np.abs(w).astype(np.float32)) * 2.0 ** 16
        assert np.all(np.abs(g.numpy() - w) <= ulp)
