"""Exact viscous Burgers solution via Cole–Hopf + Gauss–Hermite
quadrature (numpy only).

A copy of ``datagen/burgers_exact.py``: every operation keeps its
order, so the same arguments give the JAX package's bits.

Problem: u_t + u u_x = nu u_xx on [-1, 1], u(x, 0) = -sin(pi x),
u(+-1, t) = 0.  The Cole–Hopf transform gives

    u(x, t) = -∫ sin(pi(x - y)) f(x - y) exp(-y²/(4 nu t)) dy
              / ∫ f(x - y) exp(-y²/(4 nu t)) dy,
    f(y) = exp(-cos(pi y) / (2 pi nu)),

and y = sqrt(4 nu t) z turns both integrals into Gauss–Hermite form.

Usage: ``python -m pinn_torch.datagen.burgers_exact [path]`` (default
``data/burgers_shock.npz``).
"""

from __future__ import annotations

import numpy as np


def burgers_viscous_exact(nu: float, x: np.ndarray, t: np.ndarray,
                          quad_points: int = 128) -> np.ndarray:
    """u on the grid, shape (len(x), len(t))."""
    z, w = np.polynomial.hermite.hermgauss(quad_points)
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    t = np.asarray(t, dtype=np.float64).reshape(-1)
    u = np.empty((x.size, t.size), dtype=np.float64)

    c = 1.0 / (2.0 * np.pi * nu)
    for j, tj in enumerate(t):
        if tj <= 0.0:
            u[:, j] = -np.sin(np.pi * x)
            continue
        a = np.sqrt(4.0 * nu * tj)
        # arg[i, k] = x_i - a * z_k
        arg = x[:, None] - a * z[None, :]
        # exp argument kept stable: -cos(pi*arg) * c is bounded by ±c.
        f = np.exp(-np.cos(np.pi * arg) * c)
        top = -np.sum(w[None, :] * np.sin(np.pi * arg) * f, axis=1)
        bot = np.sum(w[None, :] * f, axis=1)
        u[:, j] = top / bot
    return u


def burgers_viscous_periodic_exact(nu: float, x: np.ndarray,
                                   t: np.ndarray) -> np.ndarray:
    """Exact solution on the periodic domain [0, 2*pi] (the reference's
    second datagen variant, reference
    datagen/1d-burgers/burgers_viscous_time_exact2.py:10-33; unused by
    any reference experiment — ported for inventory completeness).

    This is the Basdevant et al. (Computers & Fluids 14, 1986) closed
    form: the Cole–Hopf potential is a periodic image sum

        phi(x, t) = sum_k exp(-a_k^2 / c),
        a_k = x - 4 t - 2 pi k,  c = 4 nu (t + 1),

    and u = 4 - 2 nu phi_x / phi, which simplifies to

        u = 4 + (sum_k a_k e^{-a_k^2/c}) / ((t + 1) sum_k e^{-a_k^2/c})

    since 4 nu / c = 1 / (t + 1).  The reference truncates the sum to
    the two images k in {0, 1}, which is only valid while the advected
    front x - 4t stays within one period of the window; here enough
    images are summed to cover the front's actual position (terms decay
    like exp(-(2 pi)^2 / c), so a two-image margin reaches round-off),
    making the result exactly 2*pi-periodic for all t.  Exponentials
    are shifted by their running maximum so nothing underflows as
    nu -> 0.

    Returns u on the grid, shape (len(x), len(t)).
    """
    x = np.asarray(x, dtype=np.float64).reshape(-1, 1)
    t = np.asarray(t, dtype=np.float64).reshape(1, -1)
    two_pi = 2.0 * np.pi
    front = x - 4.0 * t
    c = 4.0 * nu * (t + 1.0)
    k_lo = int(np.floor(front.min() / two_pi)) - 2
    k_hi = int(np.ceil(front.max() / two_pi)) + 2
    shift = np.full(np.broadcast_shapes(x.shape, t.shape), -np.inf)
    for k in range(k_lo, k_hi + 1):
        shift = np.maximum(shift, -(front - two_pi * k) ** 2 / c)
    num = np.zeros_like(shift)
    den = np.zeros_like(shift)
    for k in range(k_lo, k_hi + 1):
        a_k = front - two_pi * k
        p_k = np.exp(-a_k * a_k / c - shift)
        num += a_k * p_k
        den += p_k
    return 4.0 + num / ((t + 1.0) * den)


def generate(path: str = "data/burgers_shock.npz",
             nx: int = 256, nt: int = 100, quad_points: int = 128) -> dict:
    """Produce the canonical Burgers dataset (grid matches the
    reference's bundled burgers_shock.mat: x = linspace(-1,1,256),
    t = 0:0.01:0.99, nu = 0.01/pi)."""
    nu = 0.01 / np.pi
    x = np.linspace(-1.0, 1.0, nx)
    t = np.arange(nt) * 0.01
    usol = burgers_viscous_exact(nu, x, t, quad_points)
    out = {"x": x[:, None], "t": t[:, None], "usol": usol}
    if path:
        np.savez_compressed(path, **out)
    return out


if __name__ == "__main__":
    import sys
    path = sys.argv[1] if len(sys.argv) > 1 else "data/burgers_shock.npz"
    data = generate(path)
    print(f"wrote {path}: x{data['x'].shape} t{data['t'].shape} "
          f"usol{data['usol'].shape}")
