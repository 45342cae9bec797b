"""The Adam phase: ``pinn_torch.optim.AdamRunner.run`` in chunks of
``Trainer.CHUNK_CAP`` steps on the cell's batch, with the
configuration's ``adam`` settings, as ``Trainer._adam_phase`` runs it
between its log and resample boundaries.  A unit is a step."""

from __future__ import annotations

import torch

from pinn_torch import params as pcodec
from pinn_torch.optim.adam import AdamRunner
from pinn_torch.train import Trainer

from portbench import judge

RATES = {   # the end-to-end rates, each from the window's (units, evaluations)
    "adam_steps_per_s": lambda units, evals: units}
REFERENCE = "adam"
NUMBERS = judge.FIRST_STEPS   # the judge's numbers this phase reads


class Phase:
    def __init__(self, cell):
        self.cell = cell
        self.runner = AdamRunner(cell.loss_fn, cell.config["adam"])
        self.params = cell.params
        self.state = self.runner.init(self.params)
        self.steps = 0

    def _run(self, n: int):
        self.params, self.state, losses = self.runner.run(
            self.params, self.state, self.cell.batch, n)
        self.steps += n
        return losses

    def check_steps(self, n: int) -> dict:
        p0 = [a.double() for a in pcodec.leaves(self.params)]
        b1 = float(self.cell.config["adam"].get("tf_b1", 0.9))
        losses, grad = [], None
        for _ in range(n):
            losses.append(float(self._run(1)[0]))
            if grad is None:   # m after one step is (1 - b1) g
                opt = self.state.optimizer
                grad = [opt.state[a]["exp_avg"].double() / (1.0 - b1)
                        if "exp_avg" in opt.state.get(a, {})
                        else torch.zeros_like(a, dtype=torch.float64)
                        for a in self.state.leaves]
        change = [a.double() - b for a, b in
                  zip(pcodec.leaves(self.params), p0)]
        return {"losses": losses, "grad": grad, "change": change}

    def warm(self) -> None:
        self.chunk()

    def chunk(self):
        return Trainer.CHUNK_CAP, self._run(Trainer.CHUNK_CAP)

    def totals(self):
        return self.steps, self.steps
