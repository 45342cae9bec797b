"""Prediction ensembling — the measured seed-robustness recipe as a
library facility.

A copy of ``pinn/ensemble.py`` (numpy only), so that the port does not
import the JAX package.  Members' ``predict`` may return numpy arrays or
tensors; each is brought to numpy before it is combined.

Round-3 probes (RESULTS.md seed matrix) established that label-free
*selection* between deeply-converged PINN basins is unreliable — at the
convergence tail every iterate satisfies PDE + data to saturation and
the held-out residual metric mis-ranks (probe P13) — while prediction
*averaging* needs no selection at all and carries a guarantee: for
convex weights w,

    rel_l2(sum_i w_i * u_i) <= sum_i w_i * rel_l2(u_i)

by the triangle inequality, so the averaged prediction is never worse
than the weighted mean of its members, and in practice basin errors
partially cancel (measured: 1.5994e-3 uniform average at seed 1234 vs
its own 1.65e-3 bound — probe P14).

This module packages that recipe for users: combine the grid
predictions of independently trained models (different ``init_seed``,
same training data), uniformly or weighted by an inverse held-out
metric (never test labels).  The probe drivers
(experiments/tune_burgers.py P11/P14) route through these helpers.

No reference counterpart: pierremtb/PINNs-TF2.0 trains a single
network per experiment and inherits the full init lottery (reference
1d-burgers/inf_cont_burgers.py:8-10 fixes one global seed).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["average_predictions", "inverse_metric_weights", "median_predictions",
           "rel_l2", "triangle_bound", "EnsemblePINN"]


def rel_l2(u_true, u_pred) -> float:
    """Relative L2 error — the metric of reference
    1d-burgers/inf_cont_burgers.py:114-116."""
    u_true = np.asarray(u_true)
    u_pred = np.asarray(u_pred)
    return float(np.linalg.norm(u_true - u_pred, 2)
                 / np.linalg.norm(u_true, 2))


def inverse_metric_weights(vals: Sequence[float]) -> np.ndarray:
    """Convex weights proportional to 1/metric (e.g. held-out
    validation residual).  All metrics must be positive."""
    vals = np.asarray(vals, dtype=np.float64)
    if vals.ndim != 1 or vals.size == 0:
        raise ValueError("vals must be a non-empty 1-D sequence")
    if np.any(vals <= 0):
        raise ValueError("metrics must be positive to invert into weights")
    w = 1.0 / vals
    return w / w.sum()


def average_predictions(preds: Sequence[np.ndarray],
                        weights: Optional[Sequence[float]] = None
                        ) -> np.ndarray:
    """Convex combination of member predictions (uniform by default).

    ``weights`` need not be normalized; they are projected onto the
    simplex so the triangle-inequality guarantee applies.
    """
    preds = [np.asarray(p) for p in preds]
    if not preds:
        raise ValueError("need at least one prediction")
    shape = preds[0].shape
    for p in preds[1:]:
        if p.shape != shape:
            raise ValueError(f"prediction shapes differ: {shape} vs {p.shape}")
    if weights is None:
        return np.mean(preds, axis=0)
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (len(preds),):
        raise ValueError("one weight per prediction required")
    if np.any(w < 0):
        raise ValueError("weights must be non-negative")
    s = w.sum()
    if s <= 0:
        raise ValueError("weights must not all be zero")
    w = w / s
    return sum(wi * p for wi, p in zip(w, preds))


def median_predictions(preds: Sequence[np.ndarray]) -> np.ndarray:
    """Pointwise median of member predictions.

    The robust aggregator for 3+ arms: where averaging dilutes one good
    arm with a bad one (the P14 regime — uniform mean of a 5.9e-4 and a
    2.7e-3 arm lands at 1.6e-3), the pointwise median of an ODD number
    of arms follows the majority behavior at every grid point, so a
    single bad-basin arm is voted out wherever the other two agree.  No
    triangle-inequality guarantee (the median is not a convex
    combination with fixed weights), but the failure mode requires TWO
    arms wrong at the same points.
    """
    preds = [np.asarray(p) for p in preds]
    if not preds:
        raise ValueError("need at least one prediction")
    shape = preds[0].shape
    for p in preds[1:]:
        if p.shape != shape:
            raise ValueError(f"prediction shapes differ: {shape} vs {p.shape}")
    return np.median(np.stack(preds, axis=0), axis=0)


def triangle_bound(errors: Sequence[float],
                   weights: Optional[Sequence[float]] = None) -> float:
    """Guaranteed rel-L2 upper bound for the averaged prediction given
    the members' individual rel-L2 errors: sum_i w_i * err_i.

    Because member runs are deterministic (RESULTS.md: P14 re-runs
    reproduced arm errors to five digits), previously recorded member
    errors give *tight guarantees* for an averaging recipe without
    re-running it.
    """
    errors = np.asarray(errors, dtype=np.float64)
    if weights is None:
        return float(errors.mean())
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    return float(np.dot(w, errors))


def _numpy(a) -> np.ndarray:
    """A prediction as a numpy array (a tensor is copied to the host)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class EnsemblePINN:
    """Prediction-combining wrapper over trained models.

    Members are any objects with ``predict(X) -> np.ndarray`` (e.g.
    :class:`pinn_torch.api.PhysicsInformedNN` instances trained from
    different ``init_seed`` values, or closures over functional-core
    params).  ``predict`` returns the combination of member
    predictions; pass ``val_metric`` to weight members by the inverse
    of a *held-out* metric (validation residual — never test labels),
    or ``combine="median"`` for the robust pointwise median over an
    odd number of arms (the P15 recipe — votes out a single bad-basin
    member; incompatible with weights, which the median ignores).

    Usage::

        members = [train_one(init_seed=s) for s in (0, 7919, 15838)]
        ens = EnsemblePINN(members)                # uniform mean
        ens = EnsemblePINN(members, val_metric=my_val_residual)
        ens = EnsemblePINN(members, combine="median")
        u = ens.predict(X_star)
    """

    def __init__(self, members: Sequence,
                 weights: Optional[Sequence[float]] = None,
                 val_metric: Optional[Callable] = None,
                 combine: str = "mean"):
        if not members:
            raise ValueError("need at least one member")
        if weights is not None and val_metric is not None:
            raise ValueError("pass weights or val_metric, not both")
        if combine not in ("mean", "median"):
            raise ValueError(f"unknown combine mode: {combine!r}")
        if combine == "median" and (weights is not None
                                    or val_metric is not None):
            raise ValueError("the pointwise median takes no weights")
        self.combine = combine
        self.members = list(members)
        if val_metric is not None:
            self.metrics = [float(val_metric(m)) for m in self.members]
            self.weights = inverse_metric_weights(self.metrics)
        else:
            self.metrics = None
            self.weights = (None if weights is None
                            else np.asarray(weights, dtype=np.float64))

    def predict(self, X) -> np.ndarray:
        preds = [_numpy(m.predict(X)) for m in self.members]
        if self.combine == "median":
            return median_predictions(preds)
        return average_predictions(preds, self.weights)
