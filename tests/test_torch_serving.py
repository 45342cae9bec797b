"""The port's serving surfaces against the JAX package's: prediction
ensembling (pinn_torch.ensemble vs pinn.ensemble, numpy on both sides),
the torch.export artifacts (pinn_torch.export), and the serving example
end to end on the CPU at a tiny size."""

import numpy as np
import pytest
import torch

from pinn import ensemble as jax_ensemble
from pinn_torch import ensemble, export as pexport
from pinn_torch.models import mlp
from pinn_torch.problems import burgers

torch.set_num_threads(1)


def _preds(k=3, n=50, seed=0):
    rng = np.random.RandomState(seed)
    truth = rng.randn(n, 1)
    return truth, [truth + 0.1 * (j + 1) * rng.randn(n, 1) for j in range(k)]


def test_ensemble_functions_equal_the_jax_packages():
    truth, preds = _preds()
    errs = [ensemble.rel_l2(truth, p) for p in preds]
    assert errs == [jax_ensemble.rel_l2(truth, p) for p in preds]
    w = ensemble.inverse_metric_weights(errs)
    np.testing.assert_array_equal(w, jax_ensemble.inverse_metric_weights(errs))
    for weights in (None, w, [1.0, 2.0, 0.0]):
        np.testing.assert_array_equal(
            ensemble.average_predictions(preds, weights),
            jax_ensemble.average_predictions(preds, weights))
        assert ensemble.triangle_bound(errs, weights) == \
            jax_ensemble.triangle_bound(errs, weights)
    np.testing.assert_array_equal(ensemble.median_predictions(preds),
                                  jax_ensemble.median_predictions(preds))
    for bad in ([], [1.0, -1.0]):
        for mod in (ensemble, jax_ensemble):
            with pytest.raises(ValueError):
                mod.inverse_metric_weights(bad)


@pytest.mark.parametrize("kw", [{}, {"combine": "median"}, {"val_metric": "err"}])
def test_ensemble_pinn_equals_the_jax_packages(kw):
    truth, preds = _preds(seed=1)

    class Member:
        def __init__(self, p, as_tensor):
            self.p, self.as_tensor = p, as_tensor

        def predict(self, X):
            return torch.as_tensor(self.p) if self.as_tensor else self.p

    if kw.get("val_metric") == "err":
        kw = {"val_metric": lambda m: ensemble.rel_l2(truth, m.p)}
    got = ensemble.EnsemblePINN([Member(p, True) for p in preds], **kw)
    want = jax_ensemble.EnsemblePINN([Member(p, False) for p in preds], **kw)
    np.testing.assert_array_equal(got.predict(None), want.predict(None))
    assert got.metrics == want.metrics


@pytest.fixture
def net():
    params = mlp.init_mlp([2, 8, 8, 1], torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    return params, torch.tensor([-1.0, 0.0]), torch.tensor([1.0, 1.0])


def test_export_predict_round_trip_any_batch(net, tmp_path):
    params, lb, ub = net
    path = pexport.save(str(tmp_path / "u"), pexport.export_predict(params, lb, ub,
                                                                    device="cpu"))
    assert path.endswith(pexport.SUFFIX)
    served = pexport.load(str(tmp_path / "u"))      # suffix inferred
    assert (served.dtype, served.device, served.n_features) == \
        (torch.float32, torch.device("cpu"), 2)
    rng = np.random.RandomState(0)
    for n in (1, 3, 700):
        X = rng.uniform(-1, 1, (n, 2))
        want = mlp.apply(params, torch.as_tensor(X, dtype=torch.float32), lb, ub)
        got = served(X)                               # float64 numpy in
        assert got.dtype == torch.float32 and tuple(got.shape) == (n, 1)
        torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=0.0)


def test_exported_residual_equals_the_eager_one(net, tmp_path):
    """The PDE residual exports through the generic helper (physics
    monitoring in production, tests/test_export.py:72-87)."""
    params, lb, ub = net
    params = [(w.detach(), b.detach()) for w, b in params]
    nu = 0.01 / np.pi

    def f(X):
        return burgers.residual_cont(params, X, lb, ub, nu=nu)

    path = pexport.save(str(tmp_path / "f.pt2"),
                        pexport.export_fn(f, n_features=2, device="cpu"))
    served = pexport.load(path)
    X = torch.as_tensor(np.random.RandomState(3).uniform(-1, 1, (11, 2)),
                        dtype=torch.float32)
    torch.testing.assert_close(served(X), f(X), rtol=1e-5, atol=1e-6)


def test_export_casts_a_float64_model_to_float32(tmp_path):
    params = mlp.init_mlp([2, 6, 1], torch.Generator().manual_seed(1),
                          torch.float64, "cpu")
    lb, ub = torch.tensor([-1.0, 0.0], dtype=torch.float64), \
        torch.tensor([1.0, 1.0], dtype=torch.float64)
    exported = pexport.export_predict(params, lb, ub, dtype=torch.float32)
    served = pexport.load(pexport.save(str(tmp_path / "m"), exported))
    assert served.dtype == torch.float32
    X = torch.as_tensor(np.random.RandomState(2).uniform(-1, 1, (7, 2)))
    torch.testing.assert_close(served(X).double(), mlp.apply(params, X, lb, ub),
                               rtol=1e-4, atol=1e-6)


def test_serving_example_on_the_cpu(tmp_path):
    """The port's serving example at a tiny size: its own asserts hold
    (served == in-process ensemble, any batch), the weights are convex,
    and the ensemble is no worse than its worst member."""
    from pinn_torch.experiments import serving_example

    hp = {"device": "cpu", "members": 2, "N_u": 50, "N_f": 500,
          "layers": [2, 10, 10, 1], "tf_epochs": 20, "nt_epochs": 20,
          "log_frequency": 100, "artifact": str(tmp_path / "ens")}
    r = serving_example.run(hp)
    assert r["artifact"] == str(tmp_path / "ens.pt2")
    np.testing.assert_allclose(float(np.sum(r["weights"])), 1.0, rtol=1e-12)
    assert np.all(r["weights"] > 0)
    assert np.isfinite(r["error"])
    assert r["error"] <= max(r["member_errors"]) + 1e-12
