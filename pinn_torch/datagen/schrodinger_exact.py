"""1D nonlinear Schrödinger dataset via split-step Fourier integration
(numpy only).

A copy of ``datagen/schrodinger_exact.py``: every operation keeps its
order, so the same arguments give the JAX package's bits.  The problem

    i h_t + 0.5 h_xx + |h|² h = 0,   h(0, x) = 2 sech(x),
    periodic on [-5, 5),  t ∈ [0, pi/2],

is integrated by Strang splitting: a half-step nonlinear phase
rotation, a full linear step in Fourier space, a half-step nonlinear.

Usage: ``python -m pinn_torch.datagen.schrodinger_exact [path]``
(default ``data/NLS.npz``).
"""

from __future__ import annotations

import numpy as np


def nls_split_step(nx: int = 256, nt: int = 201, substeps: int = 100,
                   L: float = 10.0, t_final: float = np.pi / 2) -> dict:
    x = -L / 2 + L * np.arange(nx) / nx           # periodic grid [-5, 5)
    t = np.linspace(0.0, t_final, nt)
    k = 2.0 * np.pi * np.fft.fftfreq(nx, d=L / nx)

    h = (2.0 / np.cosh(x)).astype(np.complex128)
    uu = np.empty((nx, nt), dtype=np.complex128)
    uu[:, 0] = h

    for j in range(1, nt):
        dt = (t[j] - t[j - 1]) / substeps
        lin = np.exp(-0.5j * k ** 2 * dt)
        for _ in range(substeps):
            h = h * np.exp(0.5j * np.abs(h) ** 2 * dt)
            h = np.fft.ifft(lin * np.fft.fft(h))
            h = h * np.exp(0.5j * np.abs(h) ** 2 * dt)
        uu[:, j] = h

    return {"x": x[None, :], "tt": t[None, :], "uu": uu}


def generate(path: str = "data/NLS.npz", **kw) -> dict:
    out = nls_split_step(**kw)
    if path:
        np.savez_compressed(path, **out)
    return out


if __name__ == "__main__":
    import sys
    path = sys.argv[1] if len(sys.argv) > 1 else "data/NLS.npz"
    data = generate(path)
    print(f"wrote {path}: x{data['x'].shape} tt{data['tt'].shape} "
          f"uu{data['uu'].shape}")
