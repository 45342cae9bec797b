"""Gauss–Legendre implicit Runge–Kutta (IRK) Butcher tableaux.

A copy of ``pinn/irk.py`` (numpy only), kept beside the port so that
``pinn_torch`` never imports the JAX package.

The reference *loads* precomputed q-stage tableaux from text files in a
git submodule that is absent from the snapshot
(reference 1d-burgers/burgersutil.py:57-61 reads
``Butcher_IRK{q}.txt`` and reshapes to (q+1, q)); this module
*generates* them for arbitrary q (tested to q=500).

Construction: stages are the Gauss–Legendre collocation method —
nodes c are the roots of the shifted Legendre polynomial P_q on (0,1),
weights ``b_j`` the Gauss quadrature weights, and
``A[i, j] = ∫_0^{c_i} l_j(τ) dτ`` with ``l_j`` the Lagrange cardinal
polynomials on the nodes.  Each integral is evaluated *exactly* (the
integrand has degree q-1) by q-point Gauss quadrature rescaled to
[0, c_i]; ``l_j`` is evaluated by the barycentric formula with weights
computed in log space so q=500 does not overflow float64.

Also provides the ``q = ceil(0.5·log(eps)/log(dt))`` auto-rule the
reference applies in the discrete-identification path
(reference 1d-burgers/burgersutil.py:90).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np


class ButcherTableau(NamedTuple):
    A: np.ndarray  # (q, q) stage coupling
    b: np.ndarray  # (q,)   quadrature weights
    c: np.ndarray  # (q,)   nodes in (0, 1)


def _barycentric_log_weights(c: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """log|w_j| (normalized) and sign(w_j) for nodes ``c``."""
    diffs = c[:, None] - c[None, :]
    np.fill_diagonal(diffs, 1.0)
    logw = -np.sum(np.log(np.abs(diffs)), axis=1)
    sign = np.prod(np.sign(diffs), axis=1)
    logw -= logw.max()  # barycentric form is scale-invariant
    return logw, sign


def _lagrange_eval(c: np.ndarray, wbar: np.ndarray, x: np.ndarray) -> np.ndarray:
    """L[k, j] = l_j(x_k) by the (second) barycentric formula."""
    d = x[:, None] - c[None, :]
    hit = np.abs(d) < 1e-14
    d = np.where(hit, 1.0, d)
    terms = wbar[None, :] / d
    terms = np.where(hit, 0.0, terms)
    denom = terms.sum(axis=1, keepdims=True)
    L = terms / denom
    # Exact node hits: cardinal property l_j(c_j) = 1.
    rows = hit.any(axis=1)
    L[rows] = hit[rows].astype(L.dtype)
    return L


@lru_cache(maxsize=32)
def gauss_legendre_irk(q: int) -> ButcherTableau:
    """q-stage Gauss–Legendre IRK tableau in float64."""
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    xg, wg = np.polynomial.legendre.leggauss(q)
    c = (xg + 1.0) / 2.0
    b = wg / 2.0
    logw, sign = _barycentric_log_weights(c)
    wbar = sign * np.exp(logw)

    A = np.empty((q, q), dtype=np.float64)
    for i in range(q):
        # Gauss rule rescaled to [0, c_i]: nodes c_i * c, weights c_i * b.
        L = _lagrange_eval(c, wbar, c[i] * c)
        A[i, :] = c[i] * (b @ L)
    return ButcherTableau(A=A, b=b, c=c)


def irk_weights(q: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reference file layout: (q+1, q) stacked [A; b] plus times c
    (parity with reference 1d-burgers/burgersutil.py:57-61)."""
    tab = gauss_legendre_irk(q)
    return np.vstack([tab.A, tab.b[None, :]]), tab.c.copy()


def auto_stages(dt: float, eps: float = float(np.finfo(np.float64).eps)) -> int:
    """Stage count for machine-precision accuracy at step size dt:
    q = ceil(0.5 log(eps) / log(dt)) (reference burgersutil.py:90).

    Gauss–Legendre IRK has order 2q, so dt^(2q) <= eps.
    """
    return int(np.ceil(0.5 * np.log(eps) / np.log(dt)))
