"""hp["trace_dir"] on the port's Trainer (``torch.profiler`` in place of
``jax.profiler.trace``): a Chrome-trace JSON with ``traceEvents`` lands
under the directory, as tests/test_trace.py asks of the JAX Trainer,
and the parameters and logged losses are bitwise those of the same run
without it."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from pinn_torch import params as pcodec
from pinn_torch.models import mlp
from pinn_torch.train import Trainer
from pinn_torch.utils import Logger

torch.set_num_threads(1)


def _problem(dtype):
    params = mlp.init_mlp([2, 4, 1], torch.Generator().manual_seed(0), dtype,
                          "cpu")
    rng = np.random.RandomState(0)
    batch = {"X_u": torch.as_tensor(rng.rand(8, 2), dtype=dtype),
             "u": torch.as_tensor(rng.rand(8, 1), dtype=dtype)}
    lb, ub = torch.zeros(2, dtype=dtype), torch.ones(2, dtype=dtype)

    def loss_fn(p, b):
        return torch.mean((mlp.apply(p, b["X_u"], lb, ub) - b["u"]) ** 2)

    return params, batch, loss_fn


def _trace_files(trace_dir):
    return [f for f in glob.glob(os.path.join(trace_dir, "**", "*"),
                                 recursive=True) if os.path.isfile(f)]


def test_trace_dir_writes_profile(tmp_path):
    params, batch, loss_fn = _problem(torch.float32)
    trace_dir = str(tmp_path / "trace")
    hp = {"tf_epochs": 3, "tf_lr": 0.01, "tf_b1": 0.9, "tf_eps": None,
          "nt_epochs": 0, "log_frequency": 10, "trace_dir": trace_dir}
    Trainer(loss_fn, params, batch, hp, logger=None).fit()
    files = _trace_files(trace_dir)
    assert files, "no trace artifacts"
    path, = files
    assert path.endswith(".pt.trace.json")
    with open(path) as fh:
        trace = json.load(fh)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trace_dir_changes_no_number(tmp_path, dtype):
    """Adam then L-BFGS (Wolfe, resampling at the same draw), with and
    without the trace: every parameter and logged loss bitwise equal."""
    runs = []
    for trace in (False, True):
        params, batch, loss_fn = _problem(dtype)
        log_file = str(tmp_path / f"log{int(trace)}.jsonl")
        hp = {"tf_epochs": 6, "nt_epochs": 6, "tf_lr": 0.01,
              "log_frequency": 2, "nt_line_search": "wolfe",
              "log_file": log_file}
        if trace:
            hp["trace_dir"] = str(tmp_path / "trace")
        out = Trainer(loss_fn, params, batch, hp,
                      Logger(hp, print_fn=lambda s: None, device="cpu")).fit()
        with open(log_file) as fh:
            losses = [r["loss"] for r in map(json.loads, fh)
                      if r["event"] == "epoch"]
        runs.append((pcodec.ravel(out).numpy(), losses))
    (w0, l0), (w1, l1) = runs
    assert len(l0) == 6
    np.testing.assert_array_equal(w0, w1)
    assert l0 == l1
    assert len(_trace_files(str(tmp_path / "trace"))) == 1


def test_trace_dir_through_the_command_line(tmp_path, capsys):
    """``python -m pinn_torch run NAME --set trace_dir=...``."""
    from pinn_torch import cli
    trace_dir = str(tmp_path / "trace")
    rc = cli.main(["run", "inf_cont_burgers", "--set", "device=cpu",
                   "--set", "N_u=20", "--set", "N_f=100", "--set",
                   "layers=[2, 8, 1]", "--set", "tf_epochs=2", "--set",
                   "nt_epochs=2", "--set", f"trace_dir={trace_dir}"])
    assert rc == 0
    assert "error: " in capsys.readouterr().out
    path, = _trace_files(trace_dir)
    with open(path) as fh:
        assert json.load(fh)["traceEvents"]
