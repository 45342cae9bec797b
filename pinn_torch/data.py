"""Dataset loading and training-set preparation (numpy only).

A copy of ``pinn/data.py``: importing ``pinn.data`` would import JAX
through ``pinn/__init__.py``, and the port must not.  The RNG call order
is the reference's, so the same seed draws the same points on both
sides (tests/test_torch_data.py checks that bit for bit).

Mirrors the four ``prep_data`` dispatch paths of the reference's
burgersutil (reference 1d-burgers/burgersutil.py:27-131) and the
Schrödinger prep (reference 1dcomplex-schrodinger/schrodingerutil.py:21-61),
as explicit, separately-named functions instead of kwargs dispatch.

RNG parity: the reference seeds numpy with 1234 and the train sets are
determined by the exact sequence of ``np.random`` calls
(choice → lhs(rand + permutation per factor) → choice, etc.).  The
same call order is preserved here, and :func:`lhs` reimplements the
classic stratified Latin-hypercube scheme with pyDOE's call pattern
(one ``rand(samples, n)`` then one ``permutation`` per factor), so
with the same seed the sampled points match the reference run
bit-for-bit.

Noise caveat: on the inference paths (:func:`burgers_cont_inference`,
:func:`schrodinger_inference`) the reference's ``noise`` kwarg is a
no-op (never applied, burgersutil.py:124-131), while here ``noise > 0``
actually perturbs the data with extra ``randn`` draws — so bit-for-bit
RNG-stream parity on those two paths holds at ``noise=0`` (the only
setting the reference experiments use).  The identification/discrete
paths apply noise through the shared stream exactly as the reference
does.

Datasets are self-generated (``datagen/burgers_exact.py``,
``datagen/schrodinger_exact.py``) and stored as npz under ``data/``;
``.mat`` files (e.g. the originals from the Raissi repo) load
transparently through the same functions.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

from pinn_torch import irk

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def _load_any(path: str) -> dict:
    if path.endswith(".mat"):
        import scipy.io
        return scipy.io.loadmat(path)
    return dict(np.load(path, allow_pickle=False))


def load_burgers(path: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> x (256,1), t (100,1), usol (256,100) float64.

    Accepts ``.npz``/``.mat`` grid files, or any member of the
    reference's ``burgers_{x,t,u}.npy`` triple (the sibling files are
    derived from the name; reference datagen/1d-burgers/datagen_old.py:7-16).
    """
    path = path or os.path.join(DATA_DIR, "burgers_shock.npz")
    if path.endswith(".npy"):
        import re
        base = re.sub(r"_[xtu]\.npy$", "", path)
        x = np.load(base + "_x.npy").reshape(-1, 1).astype(np.float64)
        t = np.load(base + "_t.npy").reshape(-1, 1).astype(np.float64)
        usol = np.real(np.load(base + "_u.npy")).astype(np.float64)
        return x, t, usol
    d = _load_any(path)
    x = d["x"].reshape(-1, 1).astype(np.float64)
    t = d["t"].reshape(-1, 1).astype(np.float64)
    usol = np.real(d["usol"]).astype(np.float64)
    return x, t, usol


def load_schrodinger(path: Optional[str] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> x (256,1), t (201,1), uu (256,201) complex128."""
    path = path or os.path.join(DATA_DIR, "NLS.npz")
    d = _load_any(path)
    x = d["x"].reshape(-1, 1).astype(np.float64)
    t = d["tt"].reshape(-1, 1).astype(np.float64)
    uu = d["uu"].astype(np.complex128)
    return x, t, uu


def load_snapshots(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A spectral-solver dataset (``data/AC.npz``, ``data/KdV.npz``:
    keys ``x``, ``tt``, ``uu``) -> x (Nx, 1), t (Nt, 1), uu (Nx, Nt),
    space-major.  The experiments generate a missing file first
    (``pinn_torch.datagen``)."""
    d = _load_any(path)
    return (d["x"].flatten()[:, None], d["tt"].flatten()[:, None], d["uu"])


def lhs(n: int, samples: int, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Classic stratified Latin-hypercube sample on [0, 1]^n, (samples, n).

    Same semantics and RNG call order as pyDOE's default ``lhs``
    (which the reference uses, burgersutil.py:122): one uniform draw
    per stratum, then an independent shuffle of strata per factor.
    """
    rand = (rng or np.random).rand(samples, n)
    edges = np.linspace(0.0, 1.0, samples + 1)
    lo, hi = edges[:-1], edges[1:]
    points = lo[:, None] + rand * (hi - lo)[:, None]
    out = np.empty_like(points)
    for j in range(n):
        order = (rng or np.random).permutation(samples)
        out[:, j] = points[order, j]
    return out


# ---------------------------------------------------------------------------
# Continuous-time Burgers
# ---------------------------------------------------------------------------

class BurgersContData(NamedTuple):
    x: np.ndarray          # (Nx, 1)
    t: np.ndarray          # (Nt, 1)
    X: np.ndarray          # (Nt, Nx) meshgrid
    T: np.ndarray          # (Nt, Nx)
    Exact_u: np.ndarray    # (Nt, Nx) solution, time-major
    X_star: np.ndarray     # (Nt*Nx, 2) all grid points
    u_star: np.ndarray     # (Nt*Nx, 1)
    X_u_train: np.ndarray  # (N_u, 2) supervised points
    u_train: np.ndarray    # (N_u, 1)
    X_f: Optional[np.ndarray]  # (N_f, 2) collocation points (None in ide path)
    ub: np.ndarray         # (2,)
    lb: np.ndarray         # (2,)


def _burgers_grid(path: Optional[str]):
    x, t, usol = load_burgers(path)
    Exact_u = usol.T                              # time-major (Nt, Nx)
    X, T = np.meshgrid(x.ravel(), t.ravel())
    X_star = np.hstack([X.flatten()[:, None], T.flatten()[:, None]])
    u_star = Exact_u.flatten()[:, None]
    lb = X_star.min(axis=0)
    ub = X_star.max(axis=0)
    return x, t, X, T, Exact_u, X_star, u_star, lb, ub


def burgers_cont_inference(N_u: int, N_f: int, noise: float = 0.0,
                           path: Optional[str] = None) -> BurgersContData:
    """Continuous inference: supervised points sampled from the
    initial+boundary set, collocation by LHS over the domain
    (reference burgersutil.py:104-131)."""
    x, t, X, T, Exact_u, X_star, u_star, lb, ub = _burgers_grid(path)
    # Reference call order: a grid-wide N_u choice happens first even
    # on this path (burgersutil.py:72-75), then LHS, then the
    # boundary-set choice — preserved for RNG-stream parity.
    _ = np.random.choice(X_star.shape[0], N_u, replace=False)

    # Boundary/initial stack: t=0 row, x=lb column, x=ub column.
    ic = np.hstack([X[0:1, :].T, T[0:1, :].T])
    ic_u = Exact_u[0:1, :].T
    left = np.hstack([X[:, 0:1], T[:, 0:1]])
    left_u = Exact_u[:, 0:1]
    right = np.hstack([X[:, -1:], T[:, -1:]])
    right_u = Exact_u[:, -1:]
    X_bnd = np.vstack([ic, left, right])
    u_bnd = np.vstack([ic_u, left_u, right_u])

    X_f = lb + (ub - lb) * lhs(2, N_f)

    idx = np.random.choice(X_bnd.shape[0], N_u, replace=False)
    X_u_train = X_bnd[idx, :]
    u_train = u_bnd[idx, :]
    if noise > 0.0:
        u_train = u_train + noise * np.std(u_train) * \
            np.random.randn(*u_train.shape)
    return BurgersContData(x, t, X, T, Exact_u, X_star, u_star,
                           X_u_train, u_train, X_f, ub, lb)


def burgers_cont_identification(N_u: int, noise: float = 0.0,
                                path: Optional[str] = None) -> BurgersContData:
    """Continuous identification: N_u supervised points sampled over the
    whole domain; the residual is evaluated at the same points
    (reference burgersutil.py:72-75, :99-102 and ide_cont_burgers.py)."""
    x, t, X, T, Exact_u, X_star, u_star, lb, ub = _burgers_grid(path)
    idx = np.random.choice(X_star.shape[0], N_u, replace=False)
    X_u_train = X_star[idx, :]
    u_train = u_star[idx, :]
    if noise > 0.0:
        u_train = u_train + noise * np.std(u_train) * \
            np.random.randn(*u_train.shape)
    return BurgersContData(x, t, X, T, Exact_u, X_star, u_star,
                           X_u_train, u_train, None, ub, lb)


# ---------------------------------------------------------------------------
# Discrete-time Burgers (IRK)
# ---------------------------------------------------------------------------

class BurgersDiscInfData(NamedTuple):
    x: np.ndarray          # (Nx, 1)
    t: np.ndarray          # (Nt, 1)
    dt: float
    Exact_u: np.ndarray    # (Nt, Nx)
    x_0: np.ndarray        # (N_n, 1) snapshot-t0 sample locations
    u_0: np.ndarray        # (N_n, 1) snapshot-t0 values (+noise)
    x_1: np.ndarray        # (2, 1) boundary locations [lb; ub]
    x_star: np.ndarray     # (Nx, 1) test locations
    u_star: np.ndarray     # (Nx,) solution at t1
    IRK_weights: np.ndarray  # (q+1, q) stacked [A; b]
    IRK_times: np.ndarray  # (q,)


def burgers_disc_inference(N_n: int, q: int, lb: np.ndarray, ub: np.ndarray,
                           idx_t_0: int, idx_t_1: int, noise: float = 0.0,
                           path: Optional[str] = None) -> BurgersDiscInfData:
    """Discrete inference: noisy sample of snapshot t0, predict snapshot
    t1 via q-stage IRK (reference burgersutil.py:40-65).  IRK weights
    are generated (pinn_torch.irk), not loaded from the missing submodule."""
    x, t, usol = load_burgers(path)
    Exact_u = usol.T
    dt = float(t[idx_t_1, 0] - t[idx_t_0, 0])
    idx_x = np.random.choice(Exact_u.shape[1], N_n, replace=False)
    x_0 = x[idx_x, :]
    u_0 = Exact_u[idx_t_0:idx_t_0 + 1, idx_x].T
    u_0 = u_0 + noise * np.std(u_0) * np.random.randn(*u_0.shape)
    x_1 = np.vstack([lb, ub])
    weights, times = irk.irk_weights(q)
    return BurgersDiscInfData(x, t, dt, Exact_u, x_0, u_0, x_1,
                              x, Exact_u[idx_t_1, :], weights, times)


class BurgersDiscIdeData(NamedTuple):
    x_0: np.ndarray        # (N_0, 1)
    u_0: np.ndarray        # (N_0, 1)
    x_1: np.ndarray        # (N_1, 1)
    u_1: np.ndarray        # (N_1, 1)
    x: np.ndarray          # (Nx, 1)
    t: np.ndarray          # (Nt, 1)
    dt: float
    q: int
    Exact_u: np.ndarray    # (Nx, Nt) space-major (as the reference returns it)
    IRK_alpha: np.ndarray  # (q, q)
    IRK_beta: np.ndarray   # (1, q)


def burgers_disc_identification(N_0: int, N_1: int, idx_t_0: int, idx_t_1: int,
                                noise: float = 0.0,
                                path: Optional[str] = None) -> BurgersDiscIdeData:
    """Discrete identification: two noisy snapshots, q auto-selected
    from dt (reference burgersutil.py:77-97)."""
    x, t, usol = load_burgers(path)
    Exact_u = usol                                # space-major (Nx, Nt)
    # RNG-stream parity: the reference's prep_data executes a grid-wide
    # choice (with N_u=None) before reaching the N_0/N_1 branch
    # (burgersutil.py:72-75) — consume the identical draw.
    _ = np.random.choice(x.shape[0] * t.shape[0], None, replace=False)
    idx_x = np.random.choice(Exact_u.shape[0], N_0, replace=False)
    x_0 = x[idx_x, :]
    u_0 = Exact_u[idx_x, idx_t_0][:, None]
    u_0 = u_0 + noise * np.std(u_0) * np.random.randn(*u_0.shape)

    idx_x = np.random.choice(Exact_u.shape[0], N_1, replace=False)
    x_1 = x[idx_x, :]
    u_1 = Exact_u[idx_x, idx_t_1][:, None]
    u_1 = u_1 + noise * np.std(u_1) * np.random.randn(*u_1.shape)

    dt = float(t[idx_t_1, 0] - t[idx_t_0, 0])
    q = irk.auto_stages(dt)
    weights, _ = irk.irk_weights(q)
    return BurgersDiscIdeData(x_0, u_0, x_1, u_1, x, t, dt, q, Exact_u,
                              IRK_alpha=weights[:-1, :],
                              IRK_beta=weights[-1:, :])


# ---------------------------------------------------------------------------
# Continuous-time Schrödinger
# ---------------------------------------------------------------------------

class SchrodingerData(NamedTuple):
    x: np.ndarray          # (Nx, 1)
    t: np.ndarray          # (Nt, 1)
    X: np.ndarray          # (Nt, Nx)
    T: np.ndarray          # (Nt, Nx)
    Exact_u: np.ndarray    # (Nx, Nt) real part
    Exact_v: np.ndarray    # (Nx, Nt) imag part
    Exact_h: np.ndarray    # (Nx, Nt) magnitude
    X_star: np.ndarray     # (Nx*Nt, 2)
    u_star: np.ndarray     # (Nx*Nt, 1)
    v_star: np.ndarray
    h_star: np.ndarray
    X_f: np.ndarray        # (N_f, 2) collocation
    ub: np.ndarray         # (2,)
    lb: np.ndarray
    tb: np.ndarray         # (N_b, 1) sampled boundary times
    x0: np.ndarray         # (N_0, 1) sampled initial locations
    u0: np.ndarray         # (N_0, 1)
    v0: np.ndarray         # (N_0, 1)


def schrodinger_inference(N_0: int, N_b: int, N_f: int, noise: float = 0.0,
                          path: Optional[str] = None) -> SchrodingerData:
    """Initial + periodic-boundary + collocation sets
    (reference schrodingerutil.py:21-61).  Domain bounds are the
    paper's fixed lb=(-5, 0), ub=(5, pi/2)."""
    x, t, uu = load_schrodinger(path)
    Exact_u = np.real(uu)
    Exact_v = np.imag(uu)
    Exact_h = np.abs(uu)

    X, T = np.meshgrid(x.ravel(), t.ravel())
    X_star = np.hstack([X.flatten()[:, None], T.flatten()[:, None]])
    u_star = Exact_u.T.flatten()[:, None]
    v_star = Exact_v.T.flatten()[:, None]
    h_star = Exact_h.T.flatten()[:, None]

    lb = np.array([-5.0, 0.0])
    ub = np.array([5.0, np.pi / 2])

    idx_x = np.random.choice(x.shape[0], N_0, replace=False)
    x0 = x[idx_x, :]
    u0 = Exact_u[idx_x, 0:1]
    v0 = Exact_v[idx_x, 0:1]
    if noise > 0.0:
        u0 = u0 + noise * np.std(u0) * np.random.randn(*u0.shape)
        v0 = v0 + noise * np.std(v0) * np.random.randn(*v0.shape)

    idx_t = np.random.choice(t.shape[0], N_b, replace=False)
    tb = t[idx_t, :]

    X_f = lb + (ub - lb) * lhs(2, N_f)
    return SchrodingerData(x, t, X, T, Exact_u, Exact_v, Exact_h,
                           X_star, u_star, v_star, h_star, X_f,
                           ub, lb, tb, x0, u0, v0)
