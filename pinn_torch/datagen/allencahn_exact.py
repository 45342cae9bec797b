"""1D Allen–Cahn dataset via ETDRK4 spectral integration (numpy only).

A copy of ``datagen/allencahn_exact.py``: every operation keeps its
order, so the same arguments give the JAX package's bits.  The problem

    u_t - 0.0001 u_xx + 5 u^3 - 5 u = 0,
    u(0, x) = x^2 cos(pi x),   periodic on [-1, 1),   t in [0, 1],

is integrated with the stiff linear part L = 0.0001 d_xx + 5 taken
exactly in Fourier space and the cubic nonlinearity N(u) = -5 u^3 by
Kassam–Trefethen ETDRK4, whose coefficients come from
``navierstokes_spectral._etdrk4_coeffs`` (the one copy in the port).

Usage: ``python -m pinn_torch.datagen.allencahn_exact [path]``
(default ``data/AC.npz``).
"""

from __future__ import annotations

import numpy as np

from pinn_torch.datagen.navierstokes_spectral import _etdrk4_coeffs


def allencahn_etdrk4(nx: int = 512, nt: int = 201, substeps: int = 4,
                     t_final: float = 1.0, diff: float = 1e-4,
                     react: float = 5.0) -> dict:
    """Integrate u_t = diff*u_xx + react*(u - u^3) on the periodic grid
    x = -1 + 2 j/nx, saving nt frames on t = linspace(0, t_final, nt).
    Returns the reference-style dict layout {x (1,nx), tt (1,nt),
    uu (nx, nt) float64}."""
    x = -1.0 + 2.0 * np.arange(nx) / nx
    t = np.linspace(0.0, t_final, nt)
    k = 2.0 * np.pi * np.fft.fftfreq(nx, d=2.0 / nx)
    Lk = -diff * k ** 2 + react

    u = x ** 2 * np.cos(np.pi * x)
    v = np.fft.fft(u)
    uu = np.empty((nx, nt), dtype=np.float64)
    uu[:, 0] = u

    def N(vhat):
        return -react * np.fft.fft(np.fft.ifft(vhat).real ** 3)

    dt = (t[1] - t[0]) / substeps
    E, E2, Q, f1, f2, f3 = _etdrk4_coeffs(Lk, dt)
    for j in range(1, nt):
        for _ in range(substeps):
            Nv = N(v)
            a = E2 * v + Q * Nv
            Na = N(a)
            b = E2 * v + Q * Na
            Nb = N(b)
            c = E2 * a + Q * (2.0 * Nb - Nv)
            Nc = N(c)
            v = E * v + f1 * Nv + 2.0 * f2 * (Na + Nb) + f3 * Nc
        uu[:, j] = np.fft.ifft(v).real
        v = np.fft.fft(uu[:, j])  # discard imaginary round-off drift

    return {"x": x[None, :], "tt": t[None, :], "uu": uu}


def ginzburg_landau_energy(u: np.ndarray, diff: float = 1e-4,
                           react: float = 5.0, L: float = 2.0) -> float:
    """E[u] = ∫ diff/2 u_x^2 + react/4 (u^2-1)^2 dx on the periodic grid
    (spectral derivative; the mean-value quadrature is exact for
    trigonometric polynomials)."""
    u = np.asarray(u, dtype=np.float64)
    nx = u.shape[0]
    k = 2.0 * np.pi * np.fft.fftfreq(nx, d=L / nx)
    u_x = np.fft.ifft(1j * k * np.fft.fft(u)).real
    dens = 0.5 * diff * u_x ** 2 + 0.25 * react * (u ** 2 - 1.0) ** 2
    return float(dens.mean() * L)


def generate(path: str = "data/AC.npz", **kw) -> dict:
    out = allencahn_etdrk4(**kw)
    if path:
        np.savez_compressed(path, **out)
    return out


if __name__ == "__main__":
    import sys
    path = sys.argv[1] if len(sys.argv) > 1 else "data/AC.npz"
    data = generate(path)
    print(f"wrote {path}: x{data['x'].shape} tt{data['tt'].shape} "
          f"uu{data['uu'].shape}")
