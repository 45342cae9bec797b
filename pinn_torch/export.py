"""Serving export: one self-contained, batch-polymorphic artifact per
trained PINN.

Counterpart of ``pinn/export.py``.  Where the JAX package serialises
StableHLO with ``jax.export``, the port exports the prediction function
with ``torch.export`` and saves the ``ExportedProgram`` (``.pt2``):

* **weights baked in**: the function closes over the trained
  parameters, which the artifact holds as constants; serving needs no
  model code and no checkpoint, only :func:`load`;
* **batch-polymorphic**: the batch axis is exported as the symbolic
  ``Dim("n")``, so one artifact serves any request size;
* **one device**: the artifact runs on the device it was exported on
  (its constants live there), where the JAX artifact lowers for
  ``platforms=("cpu", "tpu")``.  Export on the serving device, or pass
  ``device`` to :func:`export_predict`; the artifact records its device
  and dtype, and :class:`ServingModel` moves requests there.

Functions that launch a ctypes kernel cannot be traced; the prediction
function and the eager residual (``pinn_torch.problems.burgers
.residual_cont``) are plain tensor code and export as they are.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import torch

from pinn_torch import params as pcodec
from pinn_torch.device import DeviceLike, resolve_device
from pinn_torch.models import mlp

__all__ = ["export_fn", "export_predict", "save", "load", "ServingModel"]

SUFFIX = ".pt2"
_META = "pinn_torch_meta.json"
_EXAMPLE_BATCH = 8   # the traced example's batch size (any size serves)


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, X):
        return self.fn(X)


def export_fn(fn: Callable, n_features: int, dtype=torch.float32,
              device: DeviceLike = None) -> torch.export.ExportedProgram:
    """Export ``fn(X) -> tensor`` with a symbolic batch dimension.

    ``fn`` closes over everything else it needs (trained parameters,
    domain bounds, PDE coefficients), which become constants of the
    artifact; give it tensors that own their storage (``clone()`` a
    view of a larger buffer).  ``X`` is traced as ``dtype[n, n_features]`` on
    ``device`` (default: the card) with ``n`` symbolic.
    """
    dev = resolve_device(device)
    X = torch.zeros((_EXAMPLE_BATCH, int(n_features)), dtype=dtype, device=dev)
    n = torch.export.Dim("n", min=1)
    with torch.no_grad():
        return torch.export.export(_Fn(fn), (X,), dynamic_shapes=({0: n},))


def export_predict(params, lb, ub, dtype=None,
                   device: DeviceLike = None) -> torch.export.ExportedProgram:
    """Export the trained MLP's prediction ``mlp.apply(params, X, lb,
    ub)``: the normalisation and the weights are baked in.  ``dtype``
    casts the weights and the input (serve a float64-trained model in
    float32); ``device`` moves them (default: the parameters' device).
    """
    leaf = pcodec.leaves(params)[0]
    dt = dtype or leaf.dtype
    dev = resolve_device(device) if device is not None else leaf.device
    # Copies: a leaf that views a larger buffer (the optimizer's flat
    # iterate) would save that buffer whole.
    params = pcodec.tree_map(
        lambda a: a.detach().to(dtype=dt, device=dev).clone(), params)
    lb = torch.as_tensor(lb, dtype=dt, device=dev)
    ub = torch.as_tensor(ub, dtype=dt, device=dev)
    return export_fn(lambda X: mlp.apply(params, X, lb, ub), lb.shape[-1],
                     dtype=dt, device=dev)


def _input(exported):
    """(dtype, device, n_features) of the artifact's one user input."""
    spec = next(s for s in exported.graph_signature.input_specs
                if s.kind == torch.export.graph_signature.InputKind.USER_INPUT)
    node = next(n for n in exported.graph.nodes if n.name == spec.arg.name)
    val = node.meta["val"]
    return val.dtype, val.device, int(val.shape[1])


def save(path: str, exported) -> str:
    """Write ``exported`` to ``path`` (``.pt2`` appended without an
    extension), with its input's dtype and device.  Returns the path."""
    if not os.path.splitext(path)[1]:
        path = path + SUFFIX
    dtype, device, n_features = _input(exported)
    meta = {"dtype": str(dtype).replace("torch.", ""), "device": str(device),
            "n_features": n_features}
    torch.export.save(exported, path, extra_files={_META: json.dumps(meta)})
    return path


class ServingModel:
    """A loaded artifact: ``predict(X)`` (also ``model(X)``) takes an
    (n, n_features) array or tensor and returns a tensor on the
    artifact's device, for any n."""

    def __init__(self, exported, meta: dict):
        self._exported = exported
        self._module = exported.module()
        self.dtype = getattr(torch, meta["dtype"])
        self.device = torch.device(meta["device"])
        self.n_features = meta["n_features"]

    def predict(self, X) -> torch.Tensor:
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(X)
        with torch.no_grad():
            return self._module(X.to(dtype=self.dtype, device=self.device))

    __call__ = predict


def load(path: str, expect_suffix: bool = True) -> ServingModel:
    """Read an artifact written by :func:`save` (the suffix may be
    left off)."""
    if expect_suffix and not os.path.exists(path) \
            and os.path.exists(path + SUFFIX):
        path = path + SUFFIX
    extra = {_META: ""}
    exported = torch.export.load(path, extra_files=extra)
    return ServingModel(exported, json.loads(extra[_META]))
