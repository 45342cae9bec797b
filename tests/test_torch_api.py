"""The port's facade (pinn_torch.api.PhysicsInformedNN) against the JAX
package's (pinn.api), and the Trainer's params_callback.

Both facades start from the same flat weights (the JAX model's
``get_weights`` handed to the port's ``set_weights``) and train in
float64 on the CPU on the same seed-made numpy problem, so they follow
one trajectory: final loss and weights to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.api import PhysicsInformedNN as JaxPINN
from pinn.problems import burgers as jax_burgers
from pinn_torch import params as pcodec
from pinn_torch.api import PhysicsInformedNN
from pinn_torch.ops import fused_train
from pinn_torch.problems import burgers

torch.set_num_threads(1)

HP = {"layers": [2, 10, 10, 1], "tf_epochs": 25, "tf_lr": 0.01,
      "tf_b1": 0.9, "tf_eps": None, "nt_epochs": 15, "nt_lr": 0.8,
      "nt_ncorr": 10, "log_frequency": 10}
NU = 0.01 / np.pi
LB, UB = [-1.0, -1.0], [1.0, 1.0]


def _toy_problem():
    rng = np.random.RandomState(0)
    X_u = rng.rand(20, 2) * 2 - 1
    u = np.sin(np.pi * X_u[:, 0:1])
    X_f = rng.rand(50, 2) * 2 - 1
    return X_u, u, X_f


class JaxBurgersPINN(JaxPINN):
    """tests/test_api_and_checkpoint.py's subclass, in float64."""

    def __init__(self, hp, X_f):
        super().__init__(hp, None, UB, LB, dtype=jnp.float64)
        self.X_f = self.tensor(X_f)

    def extra_batch(self):
        return {"X_f": self.X_f}

    def loss(self, params, batch):
        u_pred = self.apply(params, batch["X_u"])
        f = jax_burgers.residual_cont(params, batch["X_f"], self.lb, self.ub,
                                      nu=NU)
        return (jnp.mean(jnp.square(batch["u"] - u_pred))
                + jnp.mean(jnp.square(f)))


class BurgersPINN(PhysicsInformedNN):
    """The same subclass on the port."""

    def __init__(self, hp, X_f, dtype=torch.float64):
        super().__init__(hp, None, UB, LB, dtype=dtype, device="cpu")
        self.X_f = self.tensor(X_f)

    def extra_batch(self):
        return {"X_f": self.X_f}

    def loss(self, params, batch):
        u_pred = self.apply(params, batch["X_u"])
        f = burgers.residual_cont(params, batch["X_f"], self.lb, self.ub, nu=NU)
        return (torch.mean(torch.square(batch["u"] - u_pred))
                + torch.mean(torch.square(f)))


def _batch(model, X_u, u):
    return {"X_u": model.tensor(X_u), "u": model.tensor(u), **model.extra_batch()}


def test_facade_fit_matches_jax_in_float64():
    X_u, u, X_f = _toy_problem()
    want = JaxBurgersPINN(HP, X_f)
    got = BurgersPINN(HP, X_f)
    got.set_weights(np.asarray(want.get_weights()))
    np.testing.assert_array_equal(got.get_weights().numpy(),
                                  np.asarray(want.get_weights()))
    want.fit(X_u, u)
    got.fit(X_u, u)
    want_loss = float(want.loss(want.params, _batch(want, X_u, u)))
    with torch.no_grad():
        got_loss = float(got.loss(got.params, _batch(got, X_u, u)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    np.testing.assert_allclose(got.get_weights().numpy(),
                               np.asarray(want.get_weights()), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(got.predict(X_u), np.asarray(want.predict(X_u)),
                               rtol=1e-6, atol=1e-9)


def test_facade_weights_roundtrip():
    model = PhysicsInformedNN(HP, None, ub=UB, lb=LB, device="cpu")
    w = model.get_weights()
    assert w.shape == (pcodec.num_params(model.params),)
    pred0 = model.predict(np.zeros((3, 2)))
    model.set_weights(np.zeros(w.shape))
    assert float(np.abs(model.predict(np.zeros((3, 2)))).max()) == 0.0
    model.set_weights(w)
    np.testing.assert_array_equal(model.predict(np.zeros((3, 2))), pred0)
    assert model.get_params() == []
    assert "[2, 10, 10, 1]" in model.summary() and "float32" in model.summary()


class JaxAmplitudePINN(JaxPINN):
    """tests/test_api_and_checkpoint.py's wrapped subclass, float64."""

    def wrap_training_variables(self, params):
        return {"net": params, "p_lambda_1": jnp.zeros((), jnp.float64)}

    def net_params(self, params):
        return params["net"]

    def loss(self, params, batch):
        u_pred = (1.0 + params["p_lambda_1"]) * self.apply(params["net"],
                                                           batch["X_u"])
        return jnp.mean(jnp.square(batch["u"] - u_pred))


class AmplitudePINN(PhysicsInformedNN):
    def wrap_training_variables(self, params):
        return {"net": params,
                "p_lambda_1": torch.zeros((), dtype=self.dtype, device=self.device)}

    def net_params(self, params):
        return params["net"]

    def loss(self, params, batch):
        u_pred = (1.0 + params["p_lambda_1"]) * self.apply(params["net"],
                                                           batch["X_u"])
        return torch.mean(torch.square(batch["u"] - u_pred))


def test_wrap_training_variables_extra_leaf_matches_jax():
    """A dict-wrapped trainable set with an extra scalar: it trains, sits
    at the flat tail (sorted keys, as in JAX) and round-trips through
    get/set_weights; the run follows the JAX facade's."""
    X_u, u, _ = _toy_problem()
    hp = dict(HP, tf_epochs=40, nt_epochs=20)
    want = JaxAmplitudePINN(hp, None, UB, LB, dtype=jnp.float64)
    got = AmplitudePINN(hp, None, UB, LB, dtype=torch.float64, device="cpu")
    got.set_weights(np.asarray(want.get_weights()))
    want.fit(X_u, 2.0 * u)
    got.fit(X_u, 2.0 * u)
    lam = float(got.params["p_lambda_1"])
    assert abs(lam) > 1e-3
    w = got.get_weights()
    assert float(w[-1]) == lam
    np.testing.assert_allclose(w.numpy(), np.asarray(want.get_weights()),
                               rtol=1e-6, atol=1e-9)
    got.set_weights(w.numpy())
    assert float(got.params["p_lambda_1"]) == lam
    assert got.predict(X_u).shape == u.shape


def test_params_callback_keeps_the_facade_live():
    """The Trainer hands the current iterate to params_callback before
    every log line, so an error_fn closure sees it."""
    from pinn_torch.utils import Logger

    X_u, u, X_f = _toy_problem()
    hp = dict(HP, tf_epochs=10, nt_epochs=10, log_frequency=5)
    logger = Logger(hp, print_fn=lambda s: None, device="cpu")
    model = BurgersPINN(hp, X_f)
    model.logger = logger
    seen = []
    logger.set_error_fn(lambda: seen.append(model.get_weights()) or 0.0)
    w0 = model.get_weights()
    model.fit(X_u, u)
    assert len(seen) == 1   # the end line
    np.testing.assert_array_equal(seen[0].numpy(), model.get_weights().numpy())
    assert not torch.equal(seen[0], w0)


def test_v1_loss_facade_on_the_cpu(tmp_path):
    """The documented v1 composition, mse(u - u_pred) + make_burgers_sse
    / N_f, equals make_burgers_loss at the first iterate (both are mse_u
    + mse_f), trains, and its artifact serves what predict gives."""
    from pinn_torch import export as pexport

    rng = np.random.RandomState(4)
    X_u = np.array([-1.0, 0.0]) + np.array([2.0, 1.0]) * rng.rand(30, 2)
    u = -np.sin(np.pi * X_u[:, 0:1])
    X_f = np.array([-1.0, 0.0]) + np.array([2.0, 1.0]) * rng.rand(300, 2)
    lb, ub = [-1.0, 0.0], [1.0, 1.0]

    class V1PINN(PhysicsInformedNN):
        def __init__(self):
            super().__init__(dict(HP, tf_epochs=20, nt_epochs=10), None, ub, lb,
                             dtype=torch.float32, device="cpu")
            self.sse = fused_train.make_burgers_sse(lb, ub, NU)

        def extra_batch(self):
            return {"X_f": self.tensor(X_f)}

        def loss(self, params, batch):
            u_pred = self.apply(params, batch["X_u"])
            return (torch.mean(torch.square(batch["u"] - u_pred))
                    + self.sse(params, batch["X_f"]) / batch["X_f"].shape[0])

    model = V1PINN()
    batch = _batch(model, X_u, u)
    with torch.no_grad():
        v1 = float(model.loss(model.params, batch))
        fused = float(fused_train.make_burgers_loss(lb, ub, NU)(model.params,
                                                                batch))
    np.testing.assert_allclose(v1, fused, rtol=1e-5)
    model.fit(X_u, u)
    with torch.no_grad():
        assert float(model.loss(model.params, batch)) < v1
    path = model.export_serving(str(tmp_path / "v1"))
    assert path.endswith(".pt2")
    served = pexport.load(str(tmp_path / "v1"))
    for n in (1, 7):
        np.testing.assert_allclose(served(X_u[:n]).numpy(), model.predict(X_u[:n]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["float64", torch.float64])
def test_default_dtype(monkeypatch, name):
    from pinn_torch import dtypes
    monkeypatch.setattr(dtypes, "_DEFAULT", dtypes.default_dtype())
    assert dtypes.default_dtype() == torch.float32
    dtypes.set_default_dtype(name)
    assert dtypes.default_dtype() == torch.float64
    assert PhysicsInformedNN(HP, None, UB, LB, device="cpu").dtype == torch.float64
    with pytest.raises(ValueError, match="float32 or float64"):
        dtypes.set_default_dtype(torch.float16)
