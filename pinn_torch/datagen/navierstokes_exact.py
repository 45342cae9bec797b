"""2D incompressible Navier–Stokes dataset: the Taylor–Green vortex.

A copy of ``datagen/navierstokes_exact.py`` (numpy only; the port
imports nothing of the JAX package's trees).  The closed-form decaying
vortex on the periodic box (x, y) in [0, 2 pi]^2,

    u = -cos(x) sin(y) exp(-2 nu t),   v = sin(x) cos(y) exp(-2 nu t),
    p = -(1/4) (cos(2x) + cos(2y)) exp(-4 nu t),

solves the momentum equations with lambda1 = 1 and lambda2 = nu, and
derives from the stream function psi = cos(x) cos(y) exp(-2 nu t)
(u = psi_y, v = -psi_x).  Its advection term is a pure pressure
gradient, so lambda1 is not identifiable from it; the spectral DNS
(:mod:`pinn_torch.datagen.navierstokes_spectral`) is the default
dataset.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NU_STAR = 0.01        # viscosity: same magnitude class as Burgers' nu
LAMBDA1_STAR = 1.0


def exact_uvp(t, x, y, nu: float = NU_STAR):
    """Closed-form (u, v, p) at broadcastable (t, x, y) arrays."""
    e2 = np.exp(-2.0 * nu * t)
    u = -np.cos(x) * np.sin(y) * e2
    v = np.sin(x) * np.cos(y) * e2
    p = -0.25 * (np.cos(2.0 * x) + np.cos(2.0 * y)) * e2 * e2
    return u, v, p


def exact_psi(t, x, y, nu: float = NU_STAR):
    """Stream function: u = psi_y, v = -psi_x."""
    return np.cos(x) * np.cos(y) * np.exp(-2.0 * nu * t)


class NavierStokesData(NamedTuple):
    """Flattened space-time grid + exact fields.

    ``X_star`` is (N, 3) with columns (x, y, t) — the input layout of
    the PINN net; ``u_star``/``v_star``/``p_star`` are (N, 1).
    """

    X_star: np.ndarray
    u_star: np.ndarray
    v_star: np.ndarray
    p_star: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    x: np.ndarray
    y: np.ndarray
    t: np.ndarray
    nu: float


def generate(nx: int = 64, ny: int = 64, nt: int = 21, t_max: float = 2.0,
             nu: float = NU_STAR) -> NavierStokesData:
    """Evaluate the exact solution on an (nx, ny, nt) tensor grid.

    The spatial box is the full period [0, 2 pi]^2 (endpoints included:
    the PINN samples points, it does not need periodic-unique nodes).
    """
    x = np.linspace(0.0, 2.0 * np.pi, nx)
    y = np.linspace(0.0, 2.0 * np.pi, ny)
    t = np.linspace(0.0, t_max, nt)
    X, Y, T = np.meshgrid(x, y, t, indexing="ij")
    u, v, p = exact_uvp(T, X, Y, nu)
    X_star = np.stack([X.ravel(), Y.ravel(), T.ravel()], axis=1)
    lb = np.array([0.0, 0.0, 0.0])
    ub = np.array([2.0 * np.pi, 2.0 * np.pi, t_max])
    return NavierStokesData(
        X_star=X_star,
        u_star=u.reshape(-1, 1), v_star=v.reshape(-1, 1),
        p_star=p.reshape(-1, 1),
        lb=lb, ub=ub, x=x, y=y, t=t, nu=nu)
