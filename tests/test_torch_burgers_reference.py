"""The Burgers continuous-inference losses of pinn_torch against the
benchmark's plain reference (``portbench/reference/burgers.py``), on
the CPU, and a rehearsal of the benchmark's two Burgers cells.

- ``make_burgers_loss`` (its plain path on the CPU) and the eager
  ``problems.burgers.loss_cont_inference``, at the recipe's [2, 20x8, 1]
  on N_u = 100 data points and N_f = 2,000 collocation points drawn as
  the benchmark draws them, with seeded random weights and biases: the
  loss and every gradient against the reference in float64.  Bars: the
  loss within 2e-6 relative, and each leaf's gradient within 2e-5 of
  the larger of its reference norm and the median leaf's.  Both paths
  read at most 1.3e-7 and 5.2e-7 at these seeds (float32 sums over
  2,100 points through a tanh net eight layers deep), and the TF32
  control at least 1.5e-4 and 8.8e-4: tenfold room on each side.
- The cells ``burgers.adam.nf1m`` and ``burgers.lbfgs.nf1m`` through
  ``portbench.harness`` (``resolve``, ``setup``, the checked first
  steps) at N_f = 2,000 on the CPU: the judge's readings against the
  float64 reference are inside the cells' own limits.
- The readers of the Wolfe counters ``wolfe_retrials_per_iter`` and
  ``wolfe_bisects_per_iter`` on given counters: per iteration, and
  None without the counters or without a device trace.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pinn_torch.ops.fused_train import make_burgers_loss
from pinn_torch.problems.burgers import loss_cont_inference
from pinn_torch.utils import trace
from portbench import harness, judge
from portbench.problems import burgers as problem
from portbench.reference import burgers as reference
from portbench.reference import precision

N_F = 2000
CELLS = ("burgers.adam.nf1m", "burgers.lbfgs.nf1m")


def _config():
    return harness.find_json("configs", "burgers_inf_cont")


def _weights(layers, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
            for a, b in zip(layers[:-1], layers[1:])]


def _program(path, pairs, batch, const):
    """The loss and its gradient leaf by leaf ([W0, b0, W1, ...])."""
    params = [(torch.tensor(w, dtype=torch.float32, requires_grad=True),
               torch.tensor(b, dtype=torch.float32, requires_grad=True))
              for w, b in pairs]
    if path == "fused":
        loss = make_burgers_loss(const["lb"], const["ub"], const["nu"])(
            params, batch)
    else:
        lb, ub = (torch.as_tensor(const[k]) for k in ("lb", "ub"))
        loss = loss_cont_inference(params, batch["X_u"], batch["u"],
                                   batch["X_f"], lb, ub, const["nu"])
    flat = [a for pair in params for a in pair]
    return loss.detach(), torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("path", ["fused", "eager"])
def test_burgers_loss_matches_the_reference(path, seed):
    cfg = _config()
    batch, const = problem.make(cfg, N_F, seed, "cpu")
    pairs = _weights(cfg["layers"], seed)
    loss, grads = _program(path, pairs, batch, const)
    flat64 = [torch.tensor(a, dtype=torch.float64)
              for pair in pairs for a in pair]
    ref, ref_grads = reference.loss_and_grad(flat64, batch, const,
                                             precision.FLOAT64)
    assert abs(float(loss) - float(ref)) <= 2e-6 * abs(float(ref))
    norms = [float(torch.linalg.vector_norm(g)) for g in ref_grads]
    floor = float(np.median(norms))
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        gap = float(torch.linalg.vector_norm(g.double() - r))
        assert gap <= 2e-5 * max(norms[i], floor), (i, gap, norms[i])


@pytest.mark.parametrize("cell", CELLS)
def test_burgers_cell_rehearsal_within_its_limits(cell):
    """The cell's set-up and checked first steps as a run makes them,
    on the CPU at a small N_f, judged against the float64 reference."""
    torch.manual_seed(0)
    spec = harness.resolve(cell)
    assert spec.config["problem"] == "burgers"
    c, _, record, counts = harness.setup(spec, 2600000007, "cpu", n_f=N_F)
    assert counts["loss_grad"] >= harness.CHECK_STEPS
    ref = harness.reference_record(spec, c.leaves0, c.inputs, c.const,
                                   precision.FLOAT64)
    values = judge.readings(record, ref)
    first = {k: v for k, v in spec.limits.items() if k in judge.FIRST_STEPS}
    assert set(first) == set(judge.FIRST_STEPS)
    assert judge.verdict(values, first), (values, first)


_WOLFE = {"lbfgs.wolfe.expand": 30, "lbfgs.wolfe.bisect": 90,
          "lbfgs.iters": 1200}


@pytest.mark.parametrize("metric,counts,busy_s,want", [
    ("wolfe_retrials_per_iter", _WOLFE, 1.0, 0.1),
    ("wolfe_bisects_per_iter", _WOLFE, 1.0, 0.075),
    ("wolfe_retrials_per_iter", {"lbfgs.iters": 1200}, 1.0, None),
    ("wolfe_bisects_per_iter", {"lbfgs.iters": 1200}, 1.0, None),
    ("wolfe_bisects_per_iter", _WOLFE, 0.0, None),
])
def test_wolfe_readers(monkeypatch, metric, counts, busy_s, want):
    """A program without the counters (the parent of this benchmark's
    Burgers cells) and a run with nothing on the device give None."""
    reader = harness.find_module("metrics", metric)
    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    ctx = SimpleNamespace(trace=SimpleNamespace(busy_s=busy_s))
    assert reader.read(ctx) == want
