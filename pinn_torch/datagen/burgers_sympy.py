"""Symbolic Cole–Hopf Burgers data generator (sympy).

Counterpart of ``datagen/burgers_sympy.py``, kept operation for
operation so the same arguments give the same grid bit for bit: the
periodic travelling-wave solution built symbolically (phi a sum of
Gaussian images, u = -2 nu phi_x / phi + 4 through ``sympy.diff`` and
``lambdify``) and sampled on a 256 x 100 grid over x in [-1, 1],
t in [0, 1], saved as ``burgers_{x,t,u}.npy``.

``n_images=2`` is the reference's two-image contract (which underflows
to NaN for t >~ 0.8, where the front leaves both images); the default
``"auto"`` takes every image whose centre the front approaches.

The generator needs sympy, which the port's other modules do not: it
is imported inside the functions, and its absence raises an
``ImportError`` that says so.

Usage: ``python -m pinn_torch.datagen.burgers_sympy [OUT_DIR]``.
"""

from __future__ import annotations

import numpy as np


def _sympy():
    try:
        import sympy
    except ImportError as e:
        raise ImportError("pinn_torch.datagen.burgers_sympy needs sympy "
                          "(pip install sympy); the port's other "
                          "generators do not") from e
    return sympy


def build_symbolic_u(k_lo: int = 0, k_hi: int = 1):
    """Return (u_expr, (t, x, nu)) for the Cole–Hopf potential summed
    over images k in [k_lo, k_hi]:

        phi = sum_k exp(-(x - 4 t - 2 pi k)^2 / (4 nu (t + 1)))
        u   = -2 nu phi_x / phi + 4
    """
    sp = _sympy()
    x, nu, t = sp.symbols("x nu t")
    c = 4 * nu * (t + 1)
    phi = sum(sp.exp(-((x - 4 * t - 2 * sp.pi * k) ** 2) / c)
              for k in range(k_lo, k_hi + 1))
    u = -2 * nu * phi.diff(x) / phi + 4
    return u, (t, x, nu)


def sample_grid(nu: float = 0.01 / np.pi, nx: int = 256, nt: int = 100,
                x_span=(-1.0, 1.0), t_span=(0.0, 1.0),
                n_images: int | str = "auto"):
    """Sample u on the grid; returns (x[nx], t[nt], u[nx, nt])."""
    sp = _sympy()
    x = np.linspace(x_span[0], x_span[1], nx)
    t = np.linspace(t_span[0], t_span[1], nt)
    if n_images == "auto":
        # Cover every image centre the front x - 4t can come near.
        front_min = x_span[0] - 4.0 * t_span[1]
        front_max = x_span[1] - 4.0 * t_span[0]
        k_lo = int(np.floor(front_min / (2 * np.pi))) - 1
        k_hi = int(np.ceil(front_max / (2 * np.pi))) + 1
    else:
        k_lo, k_hi = 0, int(n_images) - 1
    expr, syms = build_symbolic_u(k_lo, k_hi)
    ufunc = sp.lambdify(syms, expr, modules="numpy")
    X, T = np.meshgrid(x, t, indexing="ij")
    with np.errstate(invalid="ignore", divide="ignore", under="ignore"):
        u = np.asarray(ufunc(T, X, nu), dtype=np.float64)
    return x, t, u


def generate(out_dir: str = "data", n_images: int | str = "auto") -> dict:
    """Write burgers_{x,t,u}.npy as the reference generator does."""
    x, t, u = sample_grid(n_images=n_images)
    np.save(f"{out_dir}/burgers_x", x)
    np.save(f"{out_dir}/burgers_t", t)
    np.save(f"{out_dir}/burgers_u", u)
    return {"x": x, "t": t, "u": u}


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "data"
    d = generate(out)
    print(f"wrote {out}/burgers_{{x,t,u}}.npy: "
          f"x{d['x'].shape} t{d['t'].shape} u{d['u'].shape}")
