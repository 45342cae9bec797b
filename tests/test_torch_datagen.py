"""The port's dataset generators against the JAX package's ``datagen/``,
bit for bit at small grids (Allen–Cahn and KdV by ETDRK4, viscous
Burgers by Cole–Hopf quadrature and its periodic variant, Schrödinger
by split-step Fourier), and ``load_dataset`` of ``inf_disc_allencahn``
and ``ide_disc_kdv``, which generates a missing npz and writes the file
the JAX experiment writes (both in temporary directories)."""

import os
import sys

import numpy as np
import pytest

from datagen import allencahn_exact as jax_ac
from datagen import burgers_exact as jax_burgers
from datagen import kdv_exact as jax_kdv
from datagen import schrodinger_exact as jax_nls
from pinn_torch.datagen import (allencahn_exact, burgers_exact, kdv_exact,
                                schrodinger_exact)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("port,jax_mod,kw", [
    (allencahn_exact, jax_ac, {"nx": 64, "nt": 11, "substeps": 2}),
    (kdv_exact, jax_kdv, {"nx": 64, "nt": 11, "substeps": 4}),
    (schrodinger_exact, jax_nls, {"nx": 64, "nt": 11, "substeps": 5}),
], ids=["allencahn", "kdv", "schrodinger"])
def test_generate_bitwise(tmp_path, port, jax_mod, kw):
    got = port.generate(str(tmp_path / "port.npz"), **kw)
    want = jax_mod.generate(str(tmp_path / "jax.npz"), **kw)
    _dicts_equal(got, want)
    with np.load(tmp_path / "port.npz") as g, np.load(tmp_path / "jax.npz") as w:
        _dicts_equal(dict(g), dict(w))


def test_burgers_generators_bitwise(tmp_path):
    got = burgers_exact.generate(str(tmp_path / "port.npz"), nx=33, nt=7,
                                 quad_points=24)
    want = jax_burgers.generate(str(tmp_path / "jax.npz"), nx=33, nt=7,
                                quad_points=24)
    _dicts_equal(got, want)
    x = np.linspace(0.0, 2.0 * np.pi, 17)
    t = np.linspace(0.0, 3.0, 5)
    np.testing.assert_array_equal(
        burgers_exact.burgers_viscous_periodic_exact(0.05, x, t),
        jax_burgers.burgers_viscous_periodic_exact(0.05, x, t))


def test_invariants_bitwise():
    u = allencahn_exact.allencahn_etdrk4(nx=64, nt=11, substeps=2)["uu"][:, -1]
    assert np.isfinite(u).all()
    assert (allencahn_exact.ginzburg_landau_energy(u)
            == jax_ac.ginzburg_landau_energy(u))
    assert kdv_exact.kdv_invariants(u) == jax_kdv.kdv_invariants(u)


@pytest.mark.parametrize("name,npz", [("inf_disc_allencahn", "AC.npz"),
                                      ("ide_disc_kdv", "KdV.npz")])
def test_load_dataset_generates_a_missing_file(monkeypatch, tmp_path, name,
                                               npz):
    """The file the port writes is the JAX experiment's, and the arrays
    it returns are the ones read back from it."""
    import importlib
    sys.path.insert(0, os.path.join(REPO, "experiments"))
    jax_exp = importlib.import_module(name)
    torch_exp = importlib.import_module(f"pinn_torch.experiments.{name}")
    (tmp_path / "jax" / "data").mkdir(parents=True)
    monkeypatch.setattr(jax_exp, "_REPO", str(tmp_path / "jax"))
    port_path = tmp_path / "port" / npz
    port_path.parent.mkdir()
    monkeypatch.setattr(torch_exp, "DATASET", str(port_path))

    x, t, uu = torch_exp.load_dataset()
    want = jax_exp.load_dataset()
    with np.load(port_path) as g, np.load(tmp_path / "jax" / "data" / npz) as w:
        _dicts_equal(dict(g), dict(w))
    np.testing.assert_array_equal(uu, want["uu"])
    np.testing.assert_array_equal(x[:, 0], want["x"].ravel())
    np.testing.assert_array_equal(t[:, 0], want["tt"].ravel())
    # The second call reads the file it wrote.
    np.testing.assert_array_equal(torch_exp.load_dataset()[2], uu)


@pytest.mark.parametrize("n_images", ["auto", 2])
def test_sympy_generator_bitwise(tmp_path, n_images):
    """The port's sympy generator gives JAX's grid bit for bit (the NaNs
    of the two-image contract at late times included), and writes the
    same three files."""
    pytest.importorskip("sympy")
    from datagen import burgers_sympy as jax_sympy
    from pinn_torch.datagen import burgers_sympy
    kw = {"nu": 0.01 / np.pi, "nx": 40, "nt": 21, "n_images": n_images}
    for got, want in zip(burgers_sympy.sample_grid(**kw),
                         jax_sympy.sample_grid(**kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    burgers_sympy.generate(str(tmp_path / "p"), n_images=n_images)
    jax_sympy.generate(str(tmp_path / "j"), n_images=n_images)
    for name in ("burgers_x", "burgers_t", "burgers_u"):
        np.testing.assert_array_equal(np.load(tmp_path / "p" / f"{name}.npy"),
                                      np.load(tmp_path / "j" / f"{name}.npy"))


def test_sympy_generator_says_it_needs_sympy(monkeypatch):
    from pinn_torch.datagen import burgers_sympy
    monkeypatch.setitem(sys.modules, "sympy", None)
    with pytest.raises(ImportError, match="needs sympy"):
        burgers_sympy.sample_grid(nx=4, nt=3)
