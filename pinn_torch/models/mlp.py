"""Tanh MLP with forward Taylor-mode derivative streams.

Counterpart of ``pinn/models/mlp.py``: input normalisation
``2 (X - lb) / (ub - lb) - 1``, tanh hidden layers, a linear output,
glorot-normal init, and :func:`taylor_apply`, which carries
``(a, da·v1, d²a[v1,v1], da·v2)`` (and the third derivative at
order 3) through the layers in one forward pass.  Weights keep the JAX
layout ``W: (fan_in, fan_out)`` so ``X @ W`` is the layer product and
flat vectors match the JAX package byte for byte.

The functions take the parameters explicitly (a list of ``(W, b)``
pairs), as the losses and optimizers do; tensor-parallel parameters
(``pinn_torch.parallel.shard_params_tp``) take the same functions,
which then run each layer over the model shards
(``pinn_torch.parallel.tp``) with the same tanh rules; :class:`MLP` is
the ``nn.Module`` that owns such a list and predicts with it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from pinn_torch.device import DeviceLike, resolve_device
from pinn_torch.parallel import tp
from pinn_torch.parallel.mesh import TPParams
from pinn_torch.params import Params

# std of the standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def init_mlp(layers: Sequence[int], generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Params:
    """Glorot-normal init: W ~ truncated normal on [-2, 2], rescaled to
    std sqrt(2 / (fan_in + fan_out)); b = 0.

    The draw runs on the CPU from ``generator`` (a CPU
    ``torch.Generator``) so the weights do not depend on the device.
    """
    dev = resolve_device(device)
    params = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        w = torch.empty((fan_in, fan_out), dtype=dtype)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w = w * ((2.0 / (fan_in + fan_out)) ** 0.5 / _TRUNC_STD)
        params.append((w.to(dev), torch.zeros((fan_out,), dtype=dtype,
                                               device=dev)))
    return params


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype, as JAX's matmul promotes: a
    bf16 weight against float32 streams is cast in each product, so its
    gradient is rounded per product (the bf16 warmup,
    ``pinn_torch.optim.adam.net_dtype_cast``).  Equal dtypes: ``a @ w``."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def normalize(X: torch.Tensor, lb, ub) -> torch.Tensor:
    """Affine map of the domain onto [-1, 1]^din."""
    return 2.0 * (X - lb) / (ub - lb) - 1.0


def apply(params: Params, X: torch.Tensor, lb, ub) -> torch.Tensor:
    """Plain forward pass: (N, din) -> (N, dout).  Tensor-parallel
    parameters (``shard_params_tp``) run over their mesh row's model
    shards."""
    if isinstance(params, TPParams):
        return _apply_tp(params, X, lb, ub)
    a = normalize(X, lb, ub)
    for w, b in params[:-1]:
        a = torch.tanh(_mm(a, w) + b)
    w, b = params[-1]
    return _mm(a, w) + b


class TaylorOut(NamedTuple):
    """Network output and its input-directional derivatives, each (N, dout).

    value: H(X); d1: dH·v1 (u_x); d11: d²H[v1, v1] (u_xx, None if
    order < 2); d2: dH·v2 (u_t, None without v2); d111: d³H[v1, v1, v1]
    (None if order < 3).
    """

    value: torch.Tensor
    d1: torch.Tensor
    d11: Optional[torch.Tensor]
    d2: Optional[torch.Tensor]
    d111: Optional[torch.Tensor] = None


def taylor_apply(params: Params, X: torch.Tensor, lb, ub,
                 v1: torch.Tensor, v2: Optional[torch.Tensor] = None,
                 order: int = 2) -> TaylorOut:
    """Forward pass carrying directional-derivative streams.

    ``v1``/``v2`` are (din,) directions in input space.  The first
    layer's tangent is one constant row, ``(v·scale) @ W0``, broadcast
    over the points, and its second derivative is exactly zero — the
    fused kernels rely on that (they take the row, not a stream).
    """
    if isinstance(params, TPParams):
        return _taylor_apply_tp(params, X, lb, ub, v1, v2, order)
    scale = 2.0 / (ub - lb)
    a = normalize(X, lb, ub)

    w, b = params[0]
    z = _mm(a, w) + b
    z1 = _mm(v1 * scale, w).expand_as(z)
    z2 = _mm(v2 * scale, w).expand_as(z) if v2 is not None else None

    if len(params) == 1:  # single linear layer
        return _linear_out(z, z1, z2, order)

    a, a1, a11, a111, a2 = _first_rules(z, z1, z2, order)
    for w, b in params[1:-1]:
        z = _mm(a, w) + b
        z1 = _mm(a1, w)
        z11 = _mm(a11, w) if order >= 2 else None
        z111 = _mm(a111, w) if order >= 3 else None
        z2 = _mm(a2, w) if a2 is not None else None
        a, a1, a11, a111, a2 = _hidden_rules(z, z1, z11, z111, z2, order)

    w, b = params[-1]
    return TaylorOut(
        value=_mm(a, w) + b,
        d1=_mm(a1, w),
        d11=_mm(a11, w) if order >= 2 else None,
        d2=_mm(a2, w) if a2 is not None else None,
        d111=_mm(a111, w) if order >= 3 else None,
    )


def _linear_out(z, z1, z2, order: int) -> TaylorOut:
    """A single linear layer's streams: its curvature is zero."""
    return TaylorOut(
        value=z, d1=z1,
        d11=torch.zeros_like(z) if order >= 2 else None,
        d2=z2,
        d111=torch.zeros_like(z) if order >= 3 else None)


def _first_rules(z, z1, z2, order: int):
    """tanh and its Taylor rules after the first layer, whose second
    and third z-streams are exactly 0: (a, a1, a11, a111, a2)."""
    a = torch.tanh(z)
    sp = 1.0 - a * a              # tanh'
    a1 = sp * z1
    a11 = a111 = None
    if order >= 2:
        spp = -2.0 * a * sp       # tanh''
        a11 = spp * z1 * z1       # z11 of the first layer is exactly 0
    if order >= 3:
        sppp = -2.0 * sp * (1.0 - 3.0 * a * a)   # tanh'''
        a111 = sppp * z1 * z1 * z1
    a2 = sp * z2 if z2 is not None else None
    return a, a1, a11, a111, a2


def _hidden_rules(z, z1, z11, z111, z2, order: int):
    """tanh and its Taylor rules after a hidden layer:
    (a, a1, a11, a111, a2)."""
    a = torch.tanh(z)
    sp = 1.0 - a * a
    a1 = sp * z1
    a11 = a111 = None
    if order >= 2:
        spp = -2.0 * a * sp
        a11 = spp * z1 * z1 + sp * z11
    if order >= 3:
        sppp = -2.0 * sp * (1.0 - 3.0 * a * a)
        a111 = (sppp * z1 * z1 * z1
                + 3.0 * spp * z1 * z11
                + sp * z111)
    a2 = sp * z2 if z2 is not None else None
    return a, a1, a11, a111, a2


def _apply_tp(params: TPParams, X, lb, ub) -> torch.Tensor:
    """:func:`apply` over the model shards of ``params.row``."""
    devs = params.devices
    s = [normalize(X, lb, ub)]
    for l in range(len(params)):
        w, b = params[l]
        s, = tp.linear([s], w, b, params.kind(l), devs, _mm)
        if l < len(params) - 1:
            s = [torch.tanh(p) for p in s]
    return tp.gather(s, devs)


def _taylor_apply_tp(params: TPParams, X, lb, ub, v1, v2,
                     order: int) -> TaylorOut:
    """:func:`taylor_apply` over the model shards of ``params.row``:
    each layer through ``pinn_torch.parallel.tp.linear``, the tanh
    rules shard by shard, the output gathered."""
    devs = params.devices
    scale = 2.0 / (ub - lb)
    w, b = params[0]
    z, z1, z2 = tp.linear(
        [[normalize(X, lb, ub)], [v1 * scale],
         [v2 * scale] if v2 is not None else None],
        w, b, params.kind(0), devs, _mm)
    z1 = [r.expand_as(q) for r, q in zip(z1, z)]
    z2 = [r.expand_as(q) for r, q in zip(z2, z)] if z2 is not None else None

    if len(params) == 1:
        return _linear_out(*(tp.gather(t, devs) for t in (z, z1, z2)), order)

    acts = tp.map_shards(lambda z, z1, z2: _first_rules(z, z1, z2, order),
                         [z, z1, z2])
    for l in range(1, len(params) - 1):
        w, b = params[l]
        zs = tp.linear(acts, w, b, params.kind(l), devs, _mm)
        acts = tp.map_shards(lambda *zl: _hidden_rules(*zl, order), zs)

    w, b = params[-1]
    a, a1, a11, a111, a2 = (tp.gather(t, devs) for t in tp.linear(
        acts, w, b, params.kind(len(params) - 1), devs, _mm))
    return TaylorOut(value=a, d1=a1, d11=a11, d2=a2, d111=a111)


class MLP(nn.Module):
    """The tanh MLP as a module: owns the ``(W, b)`` parameters (JAX
    layout) and the domain bounds, and predicts with :func:`apply`.

    ``params()`` hands the parameters to the functional losses and
    optimizers; the Trainer updates them in place, so the module always
    predicts with the live iterate.
    """

    def __init__(self, layers: Sequence[int], lb, ub,
                 generator: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.layers = tuple(int(n) for n in layers)
        pairs = init_mlp(self.layers, generator, dtype, dev)
        self.weights = nn.ParameterList([nn.Parameter(w) for w, _ in pairs])
        self.biases = nn.ParameterList([nn.Parameter(b) for _, b in pairs])
        self.register_buffer("lb", torch.as_tensor(lb, dtype=dtype, device=dev))
        self.register_buffer("ub", torch.as_tensor(ub, dtype=dtype, device=dev))

    def params(self) -> Params:
        return list(zip(self.weights, self.biases))

    @torch.no_grad()
    def load_params(self, params: Params) -> None:
        """Copy ``params`` (same shapes) into the module's parameters."""
        for (w, b), (w_new, b_new) in zip(self.params(), params):
            w.copy_(w_new)
            b.copy_(b_new)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return apply(self.params(), X, self.lb, self.ub)
