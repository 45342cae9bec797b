"""The comparison that decides ``correct``.

The program's first steps, as its own optimizer state records them,
against the reference's steps from the same inputs and weights:

- ``loss_gap``: the largest relative gap between the program's loss and
  the reference's, over the steps compared;
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient and the reference's, each over the larger of
  that leaf's reference norm and the median leaf's;
- ``change_gap``: the same of each leaf's change over the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf with a gradient nought to rounding moves by
  round-off alone).

A phase that keeps a history the window builds up (L-BFGS) is also
judged where the window left it, once the window has closed:

- ``direction_gap``: the program's last search direction against the
  reference's direction from the same history and gradient, by the
  worst leaf: the norm of the leaf's difference over the larger of the
  leaf's reference norm and the median leaf's;
- ``final_loss_gap``: the relative gap between the program's loss at
  its last iterate and the reference's loss there.

Each number a cell reads is held to the cell's limit
(``portbench/limits/<cell>.json``, which names exactly the numbers its
phase reads): the run is correct when every number is finite and
within its limit.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List

import torch

FIRST_STEPS = ("loss_gap", "grad_gap", "change_gap")
LATE = ("direction_gap", "final_loss_gap")
NUMBERS = FIRST_STEPS + LATE
QUIET_LEAF = 1e-3


def _worst(values) -> float:
    """The largest of ``values``; inf when one is not a number."""
    values = list(values)
    return math.inf if any(math.isnan(v) for v in values) else max(values)


def _norms(leaves) -> List[float]:
    return [float(torch.linalg.vector_norm(a.double())) for a in leaves]


def _gap(got, want, keep) -> float:
    g, w = _norms(got), _norms(want)
    floor = median(w)
    return _worst(abs(g[i] - w[i]) / max(w[i], floor) for i in keep)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def readings(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers of ``program`` against ``reference`` (each a
    dict of ``losses``, ``grad`` and ``change``, leaves in one order)."""
    lp, lr = program["losses"], reference["losses"]
    if len(lp) != len(lr) or len(program["grad"]) != len(reference["grad"]):
        raise ValueError("the program and the reference compared different steps")
    loss_gap = _worst(_rel(a, b) for a, b in zip(lp, lr))
    ref_g = _norms(reference["grad"])
    floor = QUIET_LEAF * median(ref_g)
    moving = [i for i, n in enumerate(ref_g) if n >= floor]
    return {"loss_gap": loss_gap,
            "grad_gap": _gap(program["grad"], reference["grad"],
                             range(len(ref_g))),
            "change_gap": _gap(program["change"], reference["change"], moving)}


def late_readings(program: dict, reference: dict) -> Dict[str, float]:
    """The numbers of the program's state after the window against the
    reference's from it (each a dict of ``direction``, leaves in one
    order, and ``loss``)."""
    diff = [a.double() - b.double() for a, b in
            zip(program["direction"], reference["direction"])]
    want = _norms(reference["direction"])
    floor = median(want)
    return {"direction_gap": _worst(d / max(w, floor) for d, w in
                                    zip(_norms(diff), want)),
            "final_loss_gap": _rel(program["loss"], reference["loss"])}


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number of ``limits`` read, finite and within its limit."""
    if not limits or not set(limits) <= set(NUMBERS):
        raise ValueError(f"limits must name some of {NUMBERS}, got {sorted(limits)}")
    return all(name in values and math.isfinite(values[name])
               and values[name] <= limits[name] for name in limits)
