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
  in one launch, plus a fixed-shape float64 tree sum of the per-block
  partials (``pt_mlp.cuh``'s ``pt_reduce``).
- ``schrodinger_sse`` replaces ``_fwd_kernel`` (:70): the SSE alone.
- ``schrodinger_sse_grad_bf16`` and ``schrodinger_sse_bf16`` replace
  the same two with ``stream_dtype="bfloat16"`` (bf16 streams and saved
  activations, f32 accumulation; the rounding points are
  pallas_schrodinger.py:95-190's).

Each has a plain PyTorch version with the same signature
(``schrodinger_sse_grad_plain(a0, z1row, z2row, wt_args) -> (sse, gwt,
gz1row, gz2row)``), taken only for tensors on the CPU; for CUDA tensors
the wrappers launch the kernel or raise.  The f32 ones differentiate by
autograd, the bf16 ones run ``fused_train``'s explicit backward with
the bf16 rounding; as in the TPU kernel, the output bias gradient sums
the unrounded value adjoints.  Host-side prep and reassembly are
``fused_train``'s.  ``make_schrodinger_loss_dp`` is the data-parallel
loss over a ``pinn_torch.parallel`` mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from pinn_torch.ops import fused_train as ft
from pinn_torch.params import Params, leaves
from pinn_torch.utils import trace

_LIMITS = "input 2, output 2, at most 15 hidden layers of width <= 128"


def _head(U):
    """The residual misfit on the output streams: (sse, gU, ()).  The
    d/dx streams get a zero adjoint."""
    n = U.shape[1] // 4
    V, Dxx, Dt = U[:, :n], U[:, 2 * n:3 * n], U[:, 3 * n:]
    u, v = V[0:1], V[1:2]
    h2 = u * u + v * v
    f_u = Dt[0:1] + 0.5 * Dxx[1:2] + h2 * v
    f_v = Dt[1:2] - 0.5 * Dxx[0:1] - h2 * u
    g_fu, g_fv = 2.0 * f_u, 2.0 * f_v
    gV = torch.cat([g_fu * (2.0 * u * v) - g_fv * (3.0 * u * u + v * v),
                    g_fu * (u * u + 3.0 * v * v) - g_fv * (2.0 * u * v)])
    gU = torch.cat([gV, torch.zeros_like(gV),
                    torch.cat([-0.5 * g_fv, 0.5 * g_fu]),
                    torch.cat([g_fu, g_fv])], dim=1)
    return torch.sum(f_u * f_u) + torch.sum(f_v * f_v), gU, ()


def schrodinger_sse_plain(a0, z1row, z2row, wt_args) -> torch.Tensor:
    """The SSE in plain torch ops, streams stacked as the TPU kernel
    stacks them (differentiable)."""
    U, _, _ = ft._forward(a0, z1row, z2row, wt_args, ft._identity, save=False)
    return _head(U)[0]


def schrodinger_sse_grad_plain(a0, z1row, z2row, wt_args):
    """SSE and gradients of :func:`schrodinger_sse_plain` by autograd."""
    loss, g = ft._value_and_grads(
        lambda *x: schrodinger_sse_plain(a0, x[-2], x[-1], x[:-2]),
        [*wt_args, z1row, z2row])
    return loss, g[:-2], g[-2], g[-1]


def schrodinger_sse_grad_bf16_plain(a0, z1row, z2row, wt_args):
    """Plain version of ``schrodinger_sse_grad_bf16``."""
    return ft.explicit_loss_grad(_head, a0, z1row, z2row, wt_args,
                                 ft.round_bf16, rounded_bias=False)


def schrodinger_sse_bf16_plain(a0, z1row, z2row, wt_args) -> torch.Tensor:
    """Plain version of ``schrodinger_sse_bf16``."""
    return ft.explicit_loss_grad(_head, a0, z1row, z2row, wt_args,
                                 ft.round_bf16, grads=False)


def schrodinger_sse_grad(a0, z1row, z2row, wt_args, bf16: bool = False):
    """SSE and gradients ``(sse, gwt, gz1row, gz2row)``: the CUDA
    kernel (``schrodinger_sse_grad[_bf16]``) for CUDA tensors, its plain
    version for CPU tensors."""
    if not ft._on_cuda(a0):
        plain = (schrodinger_sse_grad_bf16_plain if bf16
                 else schrodinger_sse_grad_plain)
        return plain(a0, z1row, z2row, wt_args)
    ft._check_inputs(a0, None, z1row, z2row, wt_args, n_out=2)
    name = ft._entry("schrodinger_sse_grad", bf16)
    out = ft.launch(name, "schrodinger_train_sizes", _LIMITS, a0, [], z1row,
                    z2row, wt_args, bf16=bf16)
    return ft._unpack(out, z1row, z2row, wt_args)


def schrodinger_sse(a0, z1row, z2row, wt_args,
                    bf16: bool = False) -> torch.Tensor:
    """The SSE alone (0-d)."""
    if not ft._on_cuda(a0):
        plain = schrodinger_sse_bf16_plain if bf16 else schrodinger_sse_plain
        return plain(a0, z1row, z2row, wt_args)
    ft._check_inputs(a0, None, z1row, z2row, wt_args, n_out=2)
    name = ft._entry("schrodinger_sse", bf16)
    out = ft.launch(name, "schrodinger_train_sizes", _LIMITS, a0, [], z1row,
                    z2row, wt_args, grads=False)
    return out[0]


class _FusedSchrodingerSse(torch.autograd.Function):
    """Forward launches the SSE+grad kernel and stashes the gradients;
    backward is a scalar rescale by ``grad_output``."""

    @staticmethod
    def forward(ctx, a0, vx, vt, bf16, *net):
        params = ft._pairs(net)
        z1row, z2row, wt_args = ft._prep(params, vx, vt)
        sse, gwt, gz1row, gz2row = schrodinger_sse_grad(a0, z1row, z2row,
                                                        wt_args, bf16)
        ctx.save_for_backward(*ft._assemble_net_grads(params, gwt, gz1row,
                                                      gz2row, vx, vt))
        return sse

    @staticmethod
    def backward(ctx, g):
        return (None,) * 4 + tuple(g * gr for gr in ctx.saved_tensors)


def make_schrodinger_sse(lb, ub, stream_dtype=None):
    """Differentiable ``sse(params, X_f) -> sum(f_u^2 + f_v^2)``.

    With gradients wanted one ``schrodinger_sse_grad`` launch gives the
    SSE and every gradient; otherwise one ``schrodinger_sse`` launch
    gives the SSE.  ``stream_dtype="bfloat16"`` takes the ``_bf16``
    kernels; parameters and gradients stay float32.  ``X_f`` gets no
    gradient.
    """
    bf16 = ft._check_stream_dtype(stream_dtype)
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
            return _FusedSchrodingerSse.apply(a0, vx, vt, bf16, *net)
        z1row, z2row, wt_args = ft._prep(params, vx, vt)
        return schrodinger_sse(a0, z1row, z2row, wt_args, bf16)

    return sse


def make_schrodinger_loss(lb, ub, stream_dtype=None):
    """The full loss with the fused kernel on the residual term:
    ``mse_0 + mse_b + sse_f / N_f``, the IC/BC terms eager.  Batch
    keys: X0, H0, X_lb, X_ub, X_f.  With ``stream_dtype="bfloat16"``
    only the residual SSE takes bf16 streams; the IC/BC terms stay
    float32 on the float32 parameters (pallas_schrodinger.py:344-349).
    Each call runs in the span ``loss``, the IC/BC terms in
    ``loss.ic_bc`` (``pinn_torch.utils.trace``)."""
    from pinn_torch.problems import schrodinger as sprob

    fused = make_schrodinger_sse(lb, ub, stream_dtype=stream_dtype)
    lb_np = np.asarray(lb, np.float32)
    ub_np = np.asarray(ub, np.float32)
    bounds = {}   # per device, copied there once

    def loss(params: Params, batch) -> torch.Tensor:
        with trace.span("loss"):
            dev = batch["X_f"].device
            if dev not in bounds:
                bounds[dev] = ft._tangents(lb_np, ub_np, dev)[:2]
            lb_t, ub_t = bounds[dev]
            with trace.span("loss.ic_bc"):
                mse_0, mse_b = sprob.ic_bc_terms(
                    params, batch["X0"], batch["H0"], batch["X_lb"],
                    batch["X_ub"], lb_t, ub_t)
            n_f = batch["X_f"].shape[0]
            return mse_0 + mse_b + fused(params, batch["X_f"]) / n_f

    return loss


def make_schrodinger_loss_dp(lb, ub, mesh, axis: str = "data",
                             stream_dtype=None):
    """Data-parallel :func:`make_schrodinger_loss`
    (pallas_schrodinger.py:354-392): each shard of ``mesh`` runs the
    loss on its rows of ``X_f``, one residual kernel launch a shard, with
    the IC/BC terms (50 points each) on every shard; the shards are
    summed in a fixed order and divided by the shard count D
    (``pinn_torch.parallel.dp``), which gives ``mse_0 + mse_b + sse /
    N_f``.  ``N_f % D == 0`` is required, else ``ValueError``."""
    from pinn_torch.parallel.dp import data_parallel
    return data_parallel(make_schrodinger_loss(lb, ub, stream_dtype), mesh,
                         ("X_f",), axis)
