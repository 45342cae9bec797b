"""The port's Trainer on the CPU: ``epoch_extra`` strings reach the log
lines, and a non-pair parameter structure (IdeParams) trains through
both phases and its checkpoints."""

import json

import numpy as np
import torch

from pinn_torch import params as pcodec
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
