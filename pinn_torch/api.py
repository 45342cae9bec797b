"""Object-oriented facade.

Counterpart of ``pinn/api.py``: users of the reference subclass
``NeuralNetwork`` (reference utils/neuralnetwork.py) and override
``loss``; this class offers the same surface — ``fit(X_u, u)``,
``predict``, ``get_weights``/``set_weights`` (one flat vector, the
reference's element order, byte for byte the JAX facade's),
``get_params``, ``summary``, ``tensor``, ``export_serving`` — on the
port's functional core.  The overridable ``loss`` is a function of an
explicit parameter structure,

    class MyPINN(PhysicsInformedNN):
        def loss(self, params, batch):
            u_pred = self.apply(params, batch["X_u"])
            return torch.mean((batch["u"] - u_pred) ** 2) + ...

which the Trainer differentiates by autograd: it may call the fused
kernels, e.g. ``pinn_torch.ops.fused_train.make_burgers_sse``, the v1
residual SSE the JAX package documents for this use.

Differences from the JAX facade: an explicit ``device`` (default: the
card; the CPU only when named), and the initial weights come from a
``torch.Generator`` seeded with ``seed``, which draws other numbers
than JAX's key; to start from the JAX facade's weights, pass them
across with ``set_weights(np.asarray(jax_model.get_weights()))``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pinn_torch import params as pcodec
from pinn_torch.device import DeviceLike, resolve_device
from pinn_torch.dtypes import default_dtype
from pinn_torch.models import mlp
from pinn_torch.train import Trainer
from pinn_torch.utils.logger import Logger


class PhysicsInformedNN:
    """Reference-shaped base class (reference utils/neuralnetwork.py:7-159)."""

    def __init__(self, hp: dict, logger: Optional[Logger], ub, lb,
                 dtype: Optional[torch.dtype] = None, seed: int = 1234,
                 device: DeviceLike = None):
        self.hp = hp
        self.logger = logger
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype()
        self.lb = self.tensor(lb)
        self.ub = self.tensor(ub)
        self.layers = list(hp["layers"])
        self.params = mlp.init_mlp(self.layers,
                                   torch.Generator().manual_seed(seed),
                                   self.dtype, self.device)
        self._unravel = pcodec.make_unravel(self.params)
        self.trainer: Optional[Trainer] = None

    # -- overridables ------------------------------------------------------
    def loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Default: plain data MSE (reference neuralnetwork.py:51-52)."""
        u_pred = self.apply(params, batch["X_u"])
        return torch.mean(torch.square(batch["u"] - u_pred))

    def extra_batch(self) -> Dict[str, torch.Tensor]:
        """Additional tensors the loss needs (collocation points etc.)."""
        return {}

    def wrap_training_variables(self, params):
        """Extend the trainable set (reference neuralnetwork.py:61-63).

        Returns the trainable structure; override to wrap the network
        parameters with extra leaves, e.g.::

            def wrap_training_variables(self, params):
                return {"net": params,
                        "p_lambda_1": torch.zeros((), dtype=self.dtype,
                                                  device=self.device)}

        and unpack in ``loss`` (``self.apply(params["net"], ...)``).
        When the structure is wrapped, also override :meth:`net_params`
        so ``predict`` finds the MLP.  Called once, at the start of
        ``fit``; ``get_weights``/``set_weights`` then work on the wrapped
        structure (dict entries flatten in sorted key order, as in JAX:
        name extra leaves after "net" to keep them at the tail).
        """
        return params

    def net_params(self, params):
        """The MLP's ``(W, b)`` pairs inside the (possibly wrapped)
        trainables; identity unless ``wrap_training_variables`` nests."""
        return params

    def epoch_extra(self, params) -> str:
        """Per-log-line suffix (identification subclasses print lambdas)."""
        return ""

    # -- building blocks for subclass losses ------------------------------
    def apply(self, params, X):
        return mlp.apply(params, X, self.lb, self.ub)

    def taylor(self, params, X, v1, v2=None, order: int = 2):
        return mlp.taylor_apply(params, X, self.lb, self.ub, v1, v2, order)

    # -- reference API surface ---------------------------------------------
    def tensor(self, X) -> torch.Tensor:
        """``X`` as a tensor of the model's dtype on its device."""
        if isinstance(X, torch.Tensor):
            return X.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.array(X), dtype=self.dtype,
                               device=self.device)   # a copy: X may be read-only

    def fit(self, X_u, u):
        batch = {"X_u": self.tensor(X_u), "u": self.tensor(u),
                 **self.extra_batch()}
        if not getattr(self, "_wrapped", False):
            self.params = self.wrap_training_variables(self.params)
            self._unravel = pcodec.make_unravel(self.params)
            self._wrapped = True
        # params_callback keeps self.params live during training, so an
        # error_fn closure (logger.set_error_fn) sees the current
        # iterate, as in the reference where the Keras model mutates in
        # place.  Optional label-free validation: assign
        # ``model.val_fn = lambda params: float`` and set
        # hp["nt_val_every"] for best-iterate selection over L-BFGS.
        self.trainer = Trainer(
            lambda p, b: self.loss(p, b), self.params, batch, self.hp,
            self.logger, epoch_extra=lambda p: self.epoch_extra(p),
            params_callback=lambda p: setattr(self, "params", p),
            val_fn=getattr(self, "val_fn", None))
        self.params = self.trainer.fit()
        return self.params

    @torch.no_grad()
    def predict(self, X_star) -> np.ndarray:
        return self.apply(self.net_params(self.params),
                          self.tensor(X_star)).cpu().numpy()

    def get_weights(self) -> torch.Tensor:
        """Flat parameter vector, reference element order."""
        with torch.no_grad():
            return pcodec.ravel(self.params).detach().clone()

    def set_weights(self, w) -> None:
        self.params = self._unravel(self.tensor(w).reshape(-1).clone())

    def get_params(self, numpy: bool = False):
        """PDE coefficients (empty for plain inference, as in the
        reference base class)."""
        return []

    def export_serving(self, path: str, dtype=None) -> str:
        """Write the trained network as a self-contained,
        batch-polymorphic artifact for this model's device (see
        :mod:`pinn_torch.export`); returns the path.  Reload with
        ``pinn_torch.export.load``."""
        from pinn_torch import export as pexport
        exported = pexport.export_predict(self.net_params(self.params),
                                          self.lb, self.ub, dtype=dtype)
        return pexport.save(path, exported)

    def summary(self) -> str:
        n = pcodec.num_params(self.params)
        name = str(self.dtype).replace("torch.", "")
        return f"PhysicsInformedNN {self.layers} ({n} parameters, dtype={name})"
