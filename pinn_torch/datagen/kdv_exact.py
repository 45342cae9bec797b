"""1D Korteweg–de Vries dataset via ETDRK4 spectral integration (numpy
only).

A copy of ``datagen/kdv_exact.py``: every operation keeps its order,
so the same arguments give the JAX package's bits.  The Fourier form

    v_t = i lambda2 k^3 v  -  (i k / 2) lambda1 F[u^2],
    lambda1 = 1, lambda2 = 0.0025,  u(0, x) = cos(pi x),  periodic on [-1, 1),

is integrated with the dispersive linear part taken exactly and the
quadratic term (2/3-rule dealiased) by ETDRK4 on the full contour
(``_etdrk4_coeffs(real=False)``, from ``navierstokes_spectral``).

Usage: ``python -m pinn_torch.datagen.kdv_exact [path]`` (default
``data/KdV.npz``).
"""

from __future__ import annotations

import numpy as np

from pinn_torch.datagen.navierstokes_spectral import _etdrk4_coeffs


def kdv_etdrk4(nx: int = 512, nt: int = 201, substeps: int = 40,
               t_final: float = 1.0, lambda1: float = 1.0,
               lambda2: float = 0.0025) -> dict:
    """Integrate u_t = -lambda1 u u_x - lambda2 u_xxx on the periodic
    grid x = -1 + 2 j/nx, saving nt frames on t = linspace(0, t_final,
    nt).  Returns the reference-style dict layout {x (1,nx), tt (1,nt),
    uu (nx, nt) float64}."""
    x = -1.0 + 2.0 * np.arange(nx) / nx
    t = np.linspace(0.0, t_final, nt)
    k = 2.0 * np.pi * np.fft.fftfreq(nx, d=2.0 / nx)
    Lk = 1j * lambda2 * k ** 3

    # 2/3-rule dealiasing mask for the quadratic term: without it the
    # aliased energy at the highest modes feeds back through the
    # dispersive phase and corrupts the soliton train.
    dealias = np.abs(k) < (2.0 / 3.0) * np.abs(k).max()

    u = np.cos(np.pi * x)
    v = np.fft.fft(u)
    uu = np.empty((nx, nt), dtype=np.float64)
    uu[:, 0] = u

    g = -0.5j * lambda1 * k * dealias

    def N(vhat):
        u_ = np.fft.ifft(vhat).real
        return g * np.fft.fft(u_ * u_)

    dt = (t[1] - t[0]) / substeps
    E, E2, Q, f1, f2, f3 = _etdrk4_coeffs(Lk, dt, real=False)
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


def kdv_invariants(u: np.ndarray, L: float = 2.0):
    """(mass, momentum) = (∫u dx, ∫u² dx) on the periodic grid — both
    exact KdV invariants; the mean-value quadrature is spectrally
    exact."""
    u = np.asarray(u, dtype=np.float64)
    return float(u.mean() * L), float((u ** 2).mean() * L)


def generate(path: str = "data/KdV.npz", **kw) -> dict:
    out = kdv_etdrk4(**kw)
    if path:
        np.savez_compressed(path, **out)
    return out


if __name__ == "__main__":
    import sys
    path = sys.argv[1] if len(sys.argv) > 1 else "data/KdV.npz"
    data = generate(path)
    print(f"wrote {path}: x{data['x'].shape} tt{data['tt'].shape} "
          f"uu{data['uu'].shape}")
