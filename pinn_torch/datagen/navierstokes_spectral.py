"""2D incompressible Navier–Stokes dataset: pseudo-spectral DNS of
decaying 2D turbulence.

A copy of ``datagen/navierstokes_spectral.py`` with the ETDRK4
coefficients of ``datagen/allencahn_exact.py`` (numpy only; the port
imports nothing of the JAX package's trees).  Every operation keeps
its order, so numpy's FFT gives the same bits for the same arguments.

The vorticity equation

    w_t + u w_x + v w_y = nu Lap(w),      w = v_x - u_y,
    Lap(psi) = -w,  u = psi_y,  v = -psi_x,

is integrated on the periodic box [0, 2 pi]^2 with the diffusion taken
exactly by ETDRK4 and the advection dealiased by the 2/3 rule; each
saved frame's pressure solves Lap(p) = 2 (u_x v_y - u_y v_x) with zero
spatial mean.  Unlike the Taylor–Green vortex, both lambdas are
identifiable from this flow's velocities.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NU_STAR = 0.01
LAMBDA1_STAR = 1.0


def _etdrk4_coeffs(Lk: np.ndarray, dt: float, M: int = 32,
                   real: bool = True):
    """E, E2, Q, f1, f2, f3 for ETDRK4 with diagonal linear part Lk.

    Contour-integral evaluation (Kassam & Trefethen 2005): the mean of
    the phi-expressions over M points on a unit circle around each
    dt*Lk, which removes the cancellation of the closed forms near
    dt*Lk = 0.  For real Lk (``real=True``) a half-circle suffices and
    the real parts are kept; for complex Lk (``real=False``) the
    contour is the full circle of roots of unity.
    """
    E = np.exp(dt * Lk)
    E2 = np.exp(0.5 * dt * Lk)
    if real:
        r = np.exp(1j * np.pi * (np.arange(1, M + 1) - 0.5) / M)
    else:
        r = np.exp(2j * np.pi * (np.arange(1, M + 1) - 0.5) / M)
    LR = dt * Lk[:, None] + r[None, :]
    eLR = np.exp(LR)
    Q = dt * np.mean((np.exp(LR / 2) - 1.0) / LR, axis=1)
    f1 = dt * np.mean(
        (-4.0 - LR + eLR * (4.0 - 3.0 * LR + LR ** 2)) / LR ** 3, axis=1)
    f2 = dt * np.mean(
        (2.0 + LR + eLR * (-2.0 + LR)) / LR ** 3, axis=1)
    f3 = dt * np.mean(
        (-4.0 - 3.0 * LR - LR ** 2 + eLR * (4.0 - LR)) / LR ** 3, axis=1)
    if real:
        Q, f1, f2, f3 = Q.real, f1.real, f2.real, f3.real
    return E, E2, Q, f1, f2, f3


def _wavenumbers(n: int):
    return np.fft.fftfreq(n, d=1.0 / n)  # integer wavenumbers on [0,2pi)


def _initial_vorticity(nx: int, ny: int, seed: int = 0) -> np.ndarray:
    """Deterministic smooth random field: a band of low Fourier modes
    with random phases, normalized to max|w| = 3."""
    rng = np.random.RandomState(seed)
    kx = _wavenumbers(nx)[:, None]
    ky = _wavenumbers(ny)[None, :]
    k2 = kx * kx + ky * ky
    amp = np.exp(-0.5 * (np.sqrt(k2) - 3.0) ** 2)   # ring around |k|=3
    phase = np.exp(2j * np.pi * rng.rand(nx, ny))
    what = amp * phase * nx * ny
    what[0, 0] = 0.0                                 # zero mean circulation
    w = np.real(np.fft.ifft2(what))
    return 3.0 * w / np.abs(w).max()


class NSSpectralData(NamedTuple):
    """Flattened (x, y, t) grid + DNS fields, layout-compatible with
    :class:`pinn_torch.datagen.navierstokes_exact.NavierStokesData`."""

    X_star: np.ndarray   # (N, 3) columns (x, y, t)
    u_star: np.ndarray   # (N, 1)
    v_star: np.ndarray
    p_star: np.ndarray   # gauge: zero spatial mean per frame
    w_star: np.ndarray   # vorticity (diagnostics)
    lb: np.ndarray
    ub: np.ndarray
    x: np.ndarray
    y: np.ndarray
    t: np.ndarray
    nu: float


def _velocity_from_vorticity(what, kx, ky, k2inv):
    psihat = what * k2inv
    u = np.real(np.fft.ifft2(1j * ky * psihat))
    v = np.real(np.fft.ifft2(-1j * kx * psihat))
    return u, v


def _pressure(u, v, kx, ky, k2inv):
    uhat, vhat = np.fft.fft2(u), np.fft.fft2(v)
    u_x = np.real(np.fft.ifft2(1j * kx * uhat))
    u_y = np.real(np.fft.ifft2(1j * ky * uhat))
    v_x = np.real(np.fft.ifft2(1j * kx * vhat))
    v_y = np.real(np.fft.ifft2(1j * ky * vhat))
    rhs = 2.0 * (u_x * v_y - u_y * v_x)
    phat = -np.fft.fft2(rhs) * k2inv
    phat[0, 0] = 0.0
    return np.real(np.fft.ifft2(phat))


def generate(nx: int = 128, ny: int = 128, nt: int = 41,
             t_max: float = 2.0, nu: float = NU_STAR,
             substeps: int = 25, seed: int = 0) -> NSSpectralData:
    """Integrate and sample ``nt`` frames on [0, t_max].

    ``substeps`` ETDRK4 steps between saved frames; dt = t_max /
    ((nt-1) * substeps).  The defaults give dt = 2e-3 on the 128-grid.
    """
    kx = _wavenumbers(nx)[:, None]
    ky = _wavenumbers(ny)[None, :]
    k2 = kx * kx + ky * ky
    k2inv = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))

    # 2/3-rule dealiasing mask for the quadratic advection term.
    mask = ((np.abs(kx) < nx / 3.0) & (np.abs(ky) < ny / 3.0))

    Lk = (-nu * k2).ravel()
    dt = t_max / ((nt - 1) * substeps)
    E, E2, Q, f1, f2, f3 = (c.reshape(nx, ny) for c in
                            _etdrk4_coeffs(Lk, dt, real=True))

    def nonlin(what):
        psihat = what * k2inv
        u = np.real(np.fft.ifft2(1j * ky * psihat))
        v = np.real(np.fft.ifft2(-1j * kx * psihat))
        w_x = np.real(np.fft.ifft2(1j * kx * what))
        w_y = np.real(np.fft.ifft2(1j * ky * what))
        return -np.fft.fft2(u * w_x + v * w_y) * mask

    what = np.fft.fft2(_initial_vorticity(nx, ny, seed))
    x = np.linspace(0.0, 2.0 * np.pi, nx, endpoint=False)
    y = np.linspace(0.0, 2.0 * np.pi, ny, endpoint=False)
    t = np.linspace(0.0, t_max, nt)

    us, vs, ps, ws = [], [], [], []

    def save(what):
        u, v = _velocity_from_vorticity(what, kx, ky, k2inv)
        us.append(u); vs.append(v)
        ps.append(_pressure(u, v, kx, ky, k2inv))
        ws.append(np.real(np.fft.ifft2(what)))

    save(what)
    for _ in range(nt - 1):
        for _ in range(substeps):
            Nv = nonlin(what)
            a = E2 * what + Q * Nv
            Na = nonlin(a)
            b = E2 * what + Q * Na
            Nb = nonlin(b)
            c = E2 * a + Q * (2.0 * Nb - Nv)
            Nc = nonlin(c)
            what = E * what + Nv * f1 + 2.0 * (Na + Nb) * f2 + Nc * f3
        save(what)

    X, Y, T = np.meshgrid(x, y, t, indexing="ij")
    # frames are (nx, ny) per time: stack to (nx, ny, nt)
    U = np.stack(us, axis=-1)
    V = np.stack(vs, axis=-1)
    P = np.stack(ps, axis=-1)
    W = np.stack(ws, axis=-1)
    X_star = np.stack([X.ravel(), Y.ravel(), T.ravel()], axis=1)
    return NSSpectralData(
        X_star=X_star,
        u_star=U.reshape(-1, 1), v_star=V.reshape(-1, 1),
        p_star=P.reshape(-1, 1), w_star=W.reshape(-1, 1),
        lb=np.array([0.0, 0.0, 0.0]),
        ub=np.array([2.0 * np.pi, 2.0 * np.pi, t_max]),
        x=x, y=y, t=t, nu=nu)
