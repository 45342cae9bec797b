"""2D incompressible Navier–Stokes identification (psi–p formulation).

Counterpart of ``pinn/problems/navierstokes.py``: discover (lambda1,
lambda2) in

    u_t + lambda1 (u u_x + v u_y) = -p_x + lambda2 (u_xx + u_yy)
    v_t + lambda1 (u v_x + v v_y) = -p_y + lambda2 (v_xx + v_yy)

from velocity samples alone (Raissi et al. 2019 §4.1.1).  The network
maps (x, y, t) -> (psi, p); u = psi_y and v = -psi_x, so continuity
holds by construction and the pressure is learned up to its gauge
constant.

One forward pass carries the 13 derivative streams the residual needs
(value; x, y, t; xx, xy, yy, xt, yt; xxx, xxy, xyy, yyy) through the
tanh layers by the multivariate Faà-di-Bruno rules

    a_i   = s' z_i
    a_ij  = s'' z_i z_j + s' z_ij
    a_ijk = s''' z_i z_j z_k
            + s'' (z_ij z_k + z_ik z_j + z_jk z_i) + s' z_ijk,

each sum in the JAX function's term order, and autograd differentiates
through it for the loss gradient.  Every layer product goes through
``pinn_torch.models.mlp._mm``, so a bf16 weight rounds where JAX's
promotion rounds.  The oracle is nested ``torch.func.jacfwd``
(tests/test_torch_navierstokes.py).

lambda1 and lambda2 are both raw trainables initialised to 0 (no log
reparameterisation: the paper's NS lambda2 is not sign-constrained).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pinn_torch.models import mlp
from pinn_torch.parallel import tp
from pinn_torch.parallel.mesh import TPParams
from pinn_torch.problems.burgers import mse


class NSStreams(NamedTuple):
    """Network output and its (x, y, t) mixed partials, each (N, dout)."""

    v: torch.Tensor      # H
    x: torch.Tensor      # H_x
    y: torch.Tensor      # H_y
    t: torch.Tensor      # H_t
    xx: torch.Tensor
    xy: torch.Tensor
    yy: torch.Tensor
    xt: torch.Tensor
    yt: torch.Tensor
    xxx: torch.Tensor
    xxy: torch.Tensor
    xyy: torch.Tensor
    yyy: torch.Tensor


def _row(scale_i: torch.Tensor, w_i: torch.Tensor) -> torch.Tensor:
    """``scale[i] * w[i]`` in the promoted dtype, as JAX multiplies a
    float32 scale by a (possibly bf16) weight row."""
    dt = torch.promote_types(scale_i.dtype, w_i.dtype)
    return scale_i.to(dt) * w_i.to(dt)


def ns_taylor_apply(params, X: torch.Tensor, lb, ub) -> NSStreams:
    """Forward pass carrying the 13 NS derivative streams.

    ``X`` is (N, 3) with columns (x, y, t).  The first (affine) layer's
    tangents are the constant rows ``scale[i] * W0[i]`` broadcast over
    the points (an elementwise product, as in JAX, not ``(v·scale) @
    W0``), and its second and third z-streams are exactly zero.
    Tensor-parallel parameters (``shard_params_tp``) run each layer
    over their mesh row's model shards (``pinn_torch.parallel.tp``).
    """
    if isinstance(params, TPParams):
        return _ns_taylor_apply_tp(params, X, lb, ub)
    mm = mlp._mm
    scale = 2.0 / (ub - lb)
    a = mlp.normalize(X, lb, ub)

    w, b = params[0]
    z = mm(a, w) + b
    # Constant first-layer tangents along each coordinate direction.
    zx = _row(scale[0], w[0]).expand_as(z)
    zy = _row(scale[1], w[1]).expand_as(z)
    zt = _row(scale[2], w[2]).expand_as(z)

    if len(params) == 1:  # single linear layer: all curvature is zero
        zero = torch.zeros_like(z)
        return NSStreams(z, zx, zy, zt, *([zero] * 9))

    acts = _first_rules(z, zx, zy, zt)
    for w, b in params[1:-1]:
        acts = _hidden_rules(mm(acts[0], w) + b,
                             *(mm(a_i, w) for a_i in acts[1:]))

    w, b = params[-1]
    return NSStreams(mm(acts[0], w) + b, *(mm(a_i, w) for a_i in acts[1:]))


def _first_rules(z, zx, zy, zt):
    """tanh and its 13-stream rules after the first layer, whose second
    and third z-streams are exactly 0 (the :class:`NSStreams` order)."""
    a = torch.tanh(z)
    sp = 1.0 - a * a                       # tanh'
    spp = -2.0 * a * sp                    # tanh''
    sppp = -2.0 * sp * (1.0 - 3.0 * a * a)  # tanh'''
    ax, ay, at = sp * zx, sp * zy, sp * zt
    axx = spp * zx * zx
    axy = spp * zx * zy
    ayy = spp * zy * zy
    axt = spp * zx * zt
    ayt = spp * zy * zt
    axxx = sppp * zx * zx * zx
    axxy = sppp * zx * zx * zy
    axyy = sppp * zx * zy * zy
    ayyy = sppp * zy * zy * zy
    return (a, ax, ay, at, axx, axy, ayy, axt, ayt, axxx, axxy, axyy, ayyy)


def _hidden_rules(z, zx, zy, zt, zxx, zxy, zyy, zxt, zyt, zxxx, zxxy, zxyy,
                  zyyy):
    """tanh and its 13-stream rules after a hidden layer."""
    a = torch.tanh(z)
    sp = 1.0 - a * a
    spp = -2.0 * a * sp
    sppp = -2.0 * sp * (1.0 - 3.0 * a * a)

    ax, ay, at = sp * zx, sp * zy, sp * zt
    axx = spp * zx * zx + sp * zxx
    axy = spp * zx * zy + sp * zxy
    ayy = spp * zy * zy + sp * zyy
    axt = spp * zx * zt + sp * zxt
    ayt = spp * zy * zt + sp * zyt
    axxx = sppp * zx * zx * zx + 3.0 * spp * zx * zxx + sp * zxxx
    axxy = (sppp * zx * zx * zy
            + spp * (zxx * zy + 2.0 * zxy * zx) + sp * zxxy)
    axyy = (sppp * zx * zy * zy
            + spp * (zyy * zx + 2.0 * zxy * zy) + sp * zxyy)
    ayyy = sppp * zy * zy * zy + 3.0 * spp * zy * zyy + sp * zyyy
    return (a, ax, ay, at, axx, axy, ayy, axt, ayt, axxx, axxy, axyy, ayyy)


def _ns_taylor_apply_tp(params: TPParams, X, lb, ub) -> NSStreams:
    """:func:`ns_taylor_apply` over the model shards of ``params.row``:
    each layer through ``pinn_torch.parallel.tp.linear``, the rules
    shard by shard, the streams gathered."""
    mm, devs = mlp._mm, params.devices
    scale = 2.0 / (ub - lb)
    w, b = params[0]
    kind = params.kind(0)
    z, = tp.linear([[mlp.normalize(X, lb, ub)]], w, b, kind, devs, mm)
    # Each shard's tangent rows from its slice of W0's columns.
    rows = [[_row(scale[i].to(wp.device), wp[i]).expand_as(zp)
             for wp, zp in zip(tp.weight_parts(w, kind, devs), z)]
            for i in range(3)]

    if len(params) == 1:
        z, zx, zy, zt = (tp.gather(s, devs) for s in [z] + rows)
        zero = torch.zeros_like(z)
        return NSStreams(z, zx, zy, zt, *([zero] * 9))

    acts = tp.map_shards(_first_rules, [z] + rows)
    for l in range(1, len(params) - 1):
        w, b = params[l]
        acts = tp.map_shards(_hidden_rules, tp.linear(
            acts, w, b, params.kind(l), devs, mm))

    w, b = params[-1]
    return NSStreams(*(tp.gather(s, devs) for s in tp.linear(
        acts, w, b, params.kind(len(params) - 1), devs, mm)))


class NSIdeParams(NamedTuple):
    """Identification trainables: net weights + raw (lambda1, lambda2),
    the lambdas at the flat vector's tail (the codec order)."""

    net: list
    lambda1: torch.Tensor  # (1,)
    lambda2: torch.Tensor  # (1,)


def init_ide_params(net_params, dtype=None) -> NSIdeParams:
    """Both lambdas raw and 0, on the net's device."""
    w0 = net_params[0][0]
    dtype = dtype or w0.dtype
    return NSIdeParams(net=net_params,
                       lambda1=torch.zeros((1,), dtype=dtype, device=w0.device),
                       lambda2=torch.zeros((1,), dtype=dtype, device=w0.device))


def uvp_and_residual(net_params, X, lb, ub, lambda1, lambda2):
    """(u, v, p, f_u, f_v) at points X — one fused stream pass.

    u = psi_y, v = -psi_x; the momentum residuals take every mixed
    partial from the same :func:`ns_taylor_apply` call."""
    s = ns_taylor_apply(net_params, X, lb, ub)

    def psi(st):
        return st[:, 0:1]

    u, v = psi(s.y), -psi(s.x)
    u_t, u_x, u_y = psi(s.yt), psi(s.xy), psi(s.yy)
    u_xx, u_yy = psi(s.xxy), psi(s.yyy)
    v_t, v_x, v_y = -psi(s.xt), -psi(s.xx), -psi(s.xy)
    v_xx, v_yy = -psi(s.xxx), -psi(s.xyy)
    p, p_x, p_y = s.v[:, 1:2], s.x[:, 1:2], s.y[:, 1:2]

    f_u = u_t + lambda1 * (u * u_x + v * u_y) + p_x \
        - lambda2 * (u_xx + u_yy)
    f_v = v_t + lambda1 * (u * v_x + v * v_y) + p_y \
        - lambda2 * (v_xx + v_yy)
    return u, v, p, f_u, f_v


def predict_uvp(net_params, X, lb, ub):
    """(u, v, p) only, from the same full stream pass."""
    u, v, p, _, _ = uvp_and_residual(net_params, X, lb, ub, 0.0, 0.0)
    return u, v, p


def loss_identification(params: NSIdeParams, X, u, v, lb, ub, X_f=None):
    """MSE(u) + MSE(v) + MSE(f_u) + MSE(f_v), the residuals at the data
    points, or with ``X_f`` on that separate collocation set."""
    if X_f is None:
        u_pred, v_pred, _, f_u, f_v = uvp_and_residual(
            params.net, X, lb, ub, params.lambda1, params.lambda2)
    else:
        u_pred, v_pred, _, _, _ = uvp_and_residual(
            params.net, X, lb, ub, params.lambda1, params.lambda2)
        _, _, _, f_u, f_v = uvp_and_residual(
            params.net, X_f, lb, ub, params.lambda1, params.lambda2)
    return (mse(u - u_pred) + mse(v - v_pred)
            + mse(f_u) + mse(f_v))
