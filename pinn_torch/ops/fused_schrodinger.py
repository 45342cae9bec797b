"""Fused Schrödinger residual SSE: one CUDA launch for the residual term
and every parameter gradient.

Counterpart of ``pinn.ops.pallas_schrodinger``.  With (u, v) the two
outputs of the net at the collocation points,

    sse = sum_i (f_u^2 + f_v^2)_i,
    f_u = u_t + 0.5 v_xx + (u^2 + v^2) v,
    f_v = v_t - 0.5 u_xx - (u^2 + v^2) u,

and :func:`make_schrodinger_loss` adds the initial and periodic-boundary
terms, which stay eager torch (50 + 2·50 points; they were no kernel on
the TPU either): ``mse_0 + mse_b + sse / N_f``.

Kernels (``pinn_torch/csrc/schrodinger_train.cu``, built by ``_build``):

- ``schrodinger_sse_grad`` replaces ``_make_fwd_bwd_kernel`` (:95): the
  SSE, every weight gradient and the first layer's tangent-row adjoints
  in one launch, plus a fixed-order reduction of the per-tile partials.
- ``schrodinger_sse`` replaces ``_fwd_kernel`` (:70): the SSE alone.

Each has a plain PyTorch version with the same signature
(``schrodinger_sse_grad_plain(a0, z1row, z2row, wt_args) -> (sse, gwt,
gz1row, gz2row)``), taken only for tensors on the CPU; for CUDA tensors
the wrappers launch the kernel or raise.  Host-side prep and
reassembly are ``fused_train``'s.  The multi-device variant
(``make_schrodinger_loss_dp``) waits for the port's ``parallel``
package.
"""

from __future__ import annotations

import numpy as np
import torch

from pinn_torch.ops import fused_train as ft
from pinn_torch.params import Params, leaves

# Launch counts of the kernels (CUDA launches only).
n_launch_sse_grad = 0
n_launch_sse = 0

_LIMITS = "input 2, output 2, at most 15 hidden layers of width <= 128"


def schrodinger_sse_plain(a0, z1row, z2row, wt_args) -> torch.Tensor:
    """The SSE in plain torch ops, streams stacked as the TPU kernel
    stacks them."""
    V, _, Dxx, Dt = ft.streams_plain(a0, z1row, z2row, wt_args)
    u, v = V[0:1], V[1:2]
    h2 = u * u + v * v
    f_u = Dt[0:1] + 0.5 * Dxx[1:2] + h2 * v
    f_v = Dt[1:2] - 0.5 * Dxx[0:1] - h2 * u
    return torch.sum(f_u * f_u) + torch.sum(f_v * f_v)


def schrodinger_sse_grad_plain(a0, z1row, z2row, wt_args):
    """SSE and gradients of :func:`schrodinger_sse_plain` by autograd."""
    loss, g = ft._value_and_grads(
        lambda *x: schrodinger_sse_plain(a0, x[-2], x[-1], x[:-2]),
        [*wt_args, z1row, z2row])
    return loss, g[:-2], g[-2], g[-1]


def schrodinger_sse_grad(a0, z1row, z2row, wt_args):
    """SSE and gradients ``(sse, gwt, gz1row, gz2row)``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    global n_launch_sse_grad
    if not ft._on_cuda(a0):
        return schrodinger_sse_grad_plain(a0, z1row, z2row, wt_args)
    ft._check_inputs(a0, None, z1row, z2row, wt_args, n_out=2)
    out = ft.launch("schrodinger_sse_grad", "schrodinger_train_sizes",
                    _LIMITS, a0, [], z1row, z2row, wt_args)
    n_launch_sse_grad += 1
    return ft._unpack(out, z1row, z2row, wt_args)


def schrodinger_sse(a0, z1row, z2row, wt_args) -> torch.Tensor:
    """The SSE alone (0-d)."""
    global n_launch_sse
    if not ft._on_cuda(a0):
        return schrodinger_sse_plain(a0, z1row, z2row, wt_args)
    ft._check_inputs(a0, None, z1row, z2row, wt_args, n_out=2)
    out = ft.launch("schrodinger_sse", "schrodinger_train_sizes", _LIMITS,
                    a0, [], z1row, z2row, wt_args, grads=False)
    n_launch_sse += 1
    return out[0]


class _FusedSchrodingerSse(torch.autograd.Function):
    """Forward launches the SSE+grad kernel and stashes the gradients;
    backward is a scalar rescale by ``grad_output``."""

    @staticmethod
    def forward(ctx, a0, vx, vt, *net):
        params = ft._pairs(net)
        z1row, z2row, wt_args = ft._prep(params, vx, vt)
        sse, gwt, gz1row, gz2row = schrodinger_sse_grad(a0, z1row, z2row,
                                                        wt_args)
        ctx.save_for_backward(*ft._assemble_net_grads(params, gwt, gz1row,
                                                      gz2row, vx, vt))
        return sse

    @staticmethod
    def backward(ctx, g):
        return (None,) * 3 + tuple(g * gr for gr in ctx.saved_tensors)


def make_schrodinger_sse(lb, ub, stream_dtype=None):
    """Differentiable ``sse(params, X_f) -> sum(f_u^2 + f_v^2)``.

    With gradients wanted one ``schrodinger_sse_grad`` launch gives the
    SSE and every gradient; otherwise one ``schrodinger_sse`` launch
    gives the SSE.  float32 only.  ``X_f`` gets no gradient.
    """
    ft._check_stream_dtype(stream_dtype)
    lb_np = np.asarray(lb, np.float32)
    ub_np = np.asarray(ub, np.float32)
    consts = {}

    def sse(params: Params, X_f: torch.Tensor) -> torch.Tensor:
        dev = X_f.device
        if dev not in consts:
            consts[dev] = ft._tangents(lb_np, ub_np, dev)
        lb_t, ub_t, vx, vt = consts[dev]
        a0 = ft._normalise(X_f, lb_t, ub_t)
        net = leaves(params)
        if ft._wants_grad(net):
            return _FusedSchrodingerSse.apply(a0, vx, vt, *net)
        z1row, z2row, wt_args = ft._prep(params, vx, vt)
        return schrodinger_sse(a0, z1row, z2row, wt_args)

    return sse


def make_schrodinger_loss(lb, ub, stream_dtype=None):
    """The full loss with the fused kernel on the residual term:
    ``mse_0 + mse_b + sse_f / N_f``, the IC/BC terms eager.  Batch
    keys: X0, H0, X_lb, X_ub, X_f."""
    from pinn_torch.problems import schrodinger as sprob

    fused = make_schrodinger_sse(lb, ub, stream_dtype=stream_dtype)
    lb_np = np.asarray(lb, np.float32)
    ub_np = np.asarray(ub, np.float32)
    bounds = {}   # per device, copied there once

    def loss(params: Params, batch) -> torch.Tensor:
        dev = batch["X_f"].device
        if dev not in bounds:
            bounds[dev] = ft._tangents(lb_np, ub_np, dev)[:2]
        lb_t, ub_t = bounds[dev]
        mse_0, mse_b = sprob.ic_bc_terms(params, batch["X0"], batch["H0"],
                                         batch["X_lb"], batch["X_ub"],
                                         lb_t, ub_t)
        n_f = batch["X_f"].shape[0]
        return mse_0 + mse_b + fused(params, batch["X_f"]) / n_f

    return loss
