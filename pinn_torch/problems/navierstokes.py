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
    """
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

    for w, b in params[1:-1]:
        z = mm(a, w) + b
        zx, zy, zt = mm(ax, w), mm(ay, w), mm(at, w)
        zxx, zxy, zyy = mm(axx, w), mm(axy, w), mm(ayy, w)
        zxt, zyt = mm(axt, w), mm(ayt, w)
        zxxx, zxxy, zxyy, zyyy = (mm(axxx, w), mm(axxy, w), mm(axyy, w),
                                  mm(ayyy, w))

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

    w, b = params[-1]
    return NSStreams(
        v=mm(a, w) + b, x=mm(ax, w), y=mm(ay, w), t=mm(at, w),
        xx=mm(axx, w), xy=mm(axy, w), yy=mm(ayy, w), xt=mm(axt, w),
        yt=mm(ayt, w), xxx=mm(axxx, w), xxy=mm(axxy, w), xyy=mm(axyy, w),
        yyy=mm(ayyy, w))


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
