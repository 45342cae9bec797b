"""The comparison that decides ``correct`` fails what it must.

- The control, the reference in TF32 in the program's place, and the
  program with half of its collocation points left out read above the
  cell's limits, and the program as the configuration states it reads
  within them: on the CPU at a small N_f, and on a CUDA card at the
  cell's own size on three seeds (``-m cuda``).
- Whole runs with the timed path broken underneath come out not
  correct: a step that returns its state unchanged, and half of the
  batch left out with the mean taken over the rest.  (One card: no
  exchange between cards to leave out.)
"""

import pytest
import torch

from portbench import calibrate, harness, judge

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _fails(readings, limits):
    return not judge.verdict(readings, limits)


def _check_rows(rows, limits):
    for row in rows:
        assert judge.verdict(row["program"], limits), row
        assert _fails(row["control"], limits), row
        half = row["half_batch"]   # read on the numbers that it moves
        assert _fails(half, {k: v for k, v in limits.items() if k in half}), row


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_half_batch_fail_on_the_cpu(cell):
    spec = harness.resolve(cell)
    rows = [calibrate.readings_for_seed(harness, spec, s, "cpu", n_f=512,
                                        seconds=0.3)
            for s in SEEDS[:1]]
    _check_rows(rows, spec.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_half_batch_fail_at_the_cells_size(cell, cuda_card):
    spec = harness.resolve(cell)
    rows = [calibrate.readings_for_seed(harness, spec, s, cuda_card)
            for s in SEEDS]
    _check_rows(rows, spec.limits)


def _frozen_adam(monkeypatch):
    from pinn_torch.optim.adam import AdamRunner

    def run(self, params, state, batch, n_steps):
        with torch.no_grad():
            loss = self.loss_fn(params, batch)
        return params, state, loss.reshape(1).repeat(n_steps)

    monkeypatch.setattr(AdamRunner, "run", run)


def _frozen_lbfgs(monkeypatch):
    from pinn_torch.optim import lbfgs

    monkeypatch.setattr(lbfgs, "_step",
                        lambda opfunc, config, state, batch, lossfunc=None: state)


def _half_batch(monkeypatch, problem):
    make = problem.program_loss
    monkeypatch.setattr(problem, "program_loss",
                        lambda cfg, const: calibrate.half_batch(make(cfg, const)))


@pytest.mark.parametrize("fault", ["frozen_step", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    spec = harness.resolve(cell)
    if fault == "half_batch":
        _half_batch(monkeypatch, spec.problem)
    elif spec.driver.REFERENCE == "adam":
        _frozen_adam(monkeypatch)
    else:
        _frozen_lbfgs(monkeypatch)
    result, checks = harness.run_cell(cell, SEEDS[0], 0.2, False, device="cpu",
                                      n_f=512, log=lambda m: None)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in checks.values())
