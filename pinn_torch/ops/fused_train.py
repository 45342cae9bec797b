"""Fused Burgers training losses: one CUDA launch for the loss and every
parameter gradient.

Counterpart of ``pinn.ops.pallas_train.make_burgers_loss``,
``make_burgers_ide_loss``, ``make_burgers_sse`` and
``make_burgers_loss_dp`` (the data-parallel loss over a
``pinn_torch.parallel`` mesh).

Inference.  Data and collocation points ride one stream with three aux
rows (target, w, d):

    loss = sum_i w_i f_i^2,   f_i = d_i (u_i - target_i)
                                    + (1 - d_i)(u_t + u u_x - nu u_xx)_i

with w = 1/N_u on data points and 1/N_f on collocation points, so the
loss is mse(u - u_pred) + mse(f) exactly.

Identification.  Both misfits at the same N points, aux rows (target,
w_d, w_f) with w = 1/N, and trainable coefficients:

    loss = sum_i w_d (u - target)^2 + w_f f^2,
    f    = u_t + lambda1 u u_x - exp(log_lambda2) u_xx.

The kernel also returns A1 = sum g_f u u_x and A2 = sum g_f u_xx
(g_f = 2 w_f f), and the backward chains them through the exp
reparameterisation: dL/dlambda1 = A1, dL/dlog_lambda2 = -A2 e^lambda2.
(lambda1, e^lambda2) reach the kernel as a 2-float device buffer built
on the card, so a step needs no device-to-host copy.

The v1 residual SSE (``make_burgers_sse``, the building block of a
facade user's own loss): ``sse = sum_i f_i^2`` over the collocation
points alone, f32 streams.  As in the JAX ``custom_vjp`` its forward
launches the loss-only kernel and its backward the forward+backward
one, so a training step is two launches.

Kernels (``pinn_torch/csrc/burgers_train.cu``, built by ``_build``):

- ``burgers_loss_grad`` replaces ``_make_train_kernel``
  (pinn/ops/pallas_train.py:524): loss, all dW/db and the first-layer
  tangent-row adjoints in one launch, plus a fixed-shape float64 tree
  sum of the per-tile partials (``pt_mlp.cuh``'s ``pt_reduce``).
- ``burgers_loss_grad_rb`` gives ``burgers_loss_grad``'s outputs bit for
  bit on a register-blocked kernel (``pt_narrow_rb.cuh``) that keeps
  each tile's saved streams in shared memory, so it takes no workspace;
  hidden width ``RB_WIDTH`` alone.  :func:`burgers_loss_grad` launches
  it for float32 streams at that width (:func:`loss_grad_entry`).
- ``burgers_loss`` replaces ``_fwd_train_kernel`` (:576): the loss alone.
- ``burgers_ide_loss_grad`` replaces ``_make_ide_kernel`` (:847): as
  ``burgers_loss_grad``, plus A1 and A2.
- ``burgers_ide_loss`` replaces ``_fwd_ide_kernel`` (:906).
- ``burgers_loss_grad_bf16``, ``burgers_loss_bf16``,
  ``burgers_ide_loss_grad_bf16`` and ``burgers_ide_loss_bf16`` replace
  the same four with ``stream_dtype="bfloat16"``: bf16 streams and saved
  activations, f32 products and sums (the Adam warmup of the
  ``tf_net_dtype`` and ``fused_residual: "bf16"`` recipes).
- ``burgers_sse_grad`` replaces ``_make_fwd_bwd_kernel`` (:305) and
  ``burgers_sse`` replaces ``_fwd_kernel`` (:277): the v1 SSE with and
  without its gradients.

At the recipes' N the ten narrow entries are bound by latency (a few
hundred warps on 132 SMs); the source notes in ``pinn_torch/csrc/`` say
what each design does about the saved activations and the cross-block
sum.

Each kernel has a plain PyTorch version with the same signature
(``burgers_loss_grad_plain(a0, aux, z1row, z2row, wt_args, nu) ->
(loss, gwt, gz1row, gz2row)``; the ide pair takes ``lam`` after
``aux`` and returns ``glam`` = (A1, A2) last; the loss-only versions
return the loss).  The f32 ones differentiate the forward by autograd.
The bf16 ones cannot: autograd rounds an adjoint where the forward
rounded (at the activations), the TPU kernel at the pre-activation
adjoints gZ and the output adjoints gU, and it reads the saved,
rounded activations.  So they run the TPU kernel's explicit backward
(``_layer_bwd``, ``_run_backward``, pallas_train.py:170-274) on the
stacked (h, 4N) layout, with a rounding ``rnd`` applied at the TPU
kernel's points (:func:`round_bf16`; the identity gives the f32
result).  Every product takes rounded operands in float32.  The
wrappers take the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.  The host-side prep
(:func:`_prep`, :func:`_prep_points`) and reassembly
(:func:`_assemble_net_grads`) wrap both, so the CPU tests exercise
everything but the kernel body.  Both kinds of kernel take the same
float32 inputs; the bf16 ones round them as they load them, and hand
back float32 gradients, as the JAX custom_vjp does.

Spans (``pinn_torch.utils.trace``): ``loss`` around each call of a
``make_*_loss`` loss, ``loss.prep`` around the point and weight prep
and the launch's checks and buffers, ``loss.launch`` around the C call,
``loss.assemble`` around the gradients' reassembly; :func:`launch`
counts ``launch.<entry>``.

Layouts follow the TPU kernel: a0 (2, N) normalised points
(features-major), aux (3, N), per layer Wt (h_out, h_in) and b
(h_out, 1), z1row = (vx @ W0)[:, None], z2row = (vt @ W0)[:, None].
The CUDA kernel masks the ragged edge itself, so nothing is padded.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from pinn_torch.models.mlp import normalize
from pinn_torch.ops import _build
from pinn_torch.params import Params, leaves
from pinn_torch.utils import trace

TILE = 32  # points per partials row: one warp (pt_mlp.cuh PT_TILE)


# ---------------------------------------------------------------------------
# Host-side prep and reassembly (shared by the kernel and the plain path)
# ---------------------------------------------------------------------------

def _prep(params: Params, vx: torch.Tensor, vt: torch.Tensor):
    """First-layer tangent rows and the kernel's weight layout."""
    with trace.span("loss.prep"):
        w0 = params[0][0]
        z1row = (vx @ w0)[:, None]                       # (h1, 1)
        z2row = (vt @ w0)[:, None]
        wt_args = []
        for w, b in params:
            wt_args += [w.t().contiguous(), b.reshape(-1, 1)]
        return z1row, z2row, wt_args


def _normalise(X: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor):
    with trace.span("loss.prep"):
        return normalize(X, lb, ub).t().contiguous()   # (2, N)


def _prep_points(batch, lb: torch.Tensor, ub: torch.Tensor):
    """Stack [X_u; X_f], normalise, and build the aux rows (target, w, d)."""
    with trace.span("loss.prep"):
        X_u, u, X_f = batch["X_u"], batch["u"], batch["X_f"]
        n_u, n_f = X_u.shape[0], X_f.shape[0]
        dtype, dev = X_f.dtype, X_f.device
        a0 = _normalise(torch.cat([X_u, X_f], dim=0), lb, ub)
        target = torch.cat([u[:, 0],
                            torch.zeros((n_f,), dtype=dtype, device=dev)])
        w = torch.cat([torch.full((n_u,), 1.0 / n_u, dtype=dtype, device=dev),
                       torch.full((n_f,), 1.0 / n_f, dtype=dtype, device=dev)])
        d = torch.cat([torch.ones((n_u,), dtype=dtype, device=dev),
                       torch.zeros((n_f,), dtype=dtype, device=dev)])
        aux = torch.stack([target, w, d]).contiguous()             # (3, N)
        return a0, aux


def _prep_ide_points(batch, lb: torch.Tensor, ub: torch.Tensor):
    """Normalise X_u and build the aux rows (target, w_d, w_f), w = 1/N."""
    with trace.span("loss.prep"):
        X, u = batch["X_u"], batch["u"]
        n = X.shape[0]
        w = torch.full((n,), 1.0 / n, dtype=X.dtype, device=X.device)
        return _normalise(X, lb, ub), torch.stack([u[:, 0], w, w]).contiguous()


def _lam(lambda1: torch.Tensor, log_lambda2: torch.Tensor) -> torch.Tensor:
    """(lambda1, exp(log_lambda2)) as a 2-float tensor, computed on the
    coefficients' device (no host copy)."""
    return torch.cat([lambda1.reshape(1), torch.exp(log_lambda2.reshape(1))])


def _assemble_net_grads(params: Params, gwt, gz1row, gz2row, vx, vt):
    """Kernel-layout gradients -> params layout; the tangent-row
    adjoints fold into dW0 through z1row = vx @ W0, z2row = vt @ W0."""
    with trace.span("loss.assemble"):
        grads = []
        for l, (w, b) in enumerate(params):
            gw = gwt[2 * l].t()
            gb = gwt[2 * l + 1].reshape(b.shape)
            if l == 0:
                gw = (gw + torch.outer(vx, gz1row[:, 0])
                      + torch.outer(vt, gz2row[:, 0]))
            grads += [gw, gb]
        return grads


def _tangents(lb_np, ub_np, dev):
    """(lb, ub, vx, vt) on ``dev``: vx, vt are the x and t directions
    scaled into the normalised input space."""
    lb_t = torch.as_tensor(lb_np, device=dev)
    ub_t = torch.as_tensor(ub_np, device=dev)
    scale = 2.0 / (ub_t - lb_t)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return lb_t, ub_t, torch.stack([scale[0], zero]), torch.stack([zero, scale[1]])


def _check_stream_dtype(stream_dtype) -> bool:
    """True for bf16 streams, False for float32; raises on any other."""
    if stream_dtype in (None, "float32", torch.float32):
        return False
    if stream_dtype in ("bfloat16", "bf16", torch.bfloat16):
        return True
    raise ValueError(f"stream_dtype must be float32 or bfloat16, got "
                     f"{stream_dtype!r}")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest, ties to even, as JAX's
    ``astype``) and brought back to its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def _layer_fwd(wt, b, a_cat, n: int, rnd: Callable, z1row=None, z2row=None):
    """One stacked-stream layer (``_layer_fwd``, pallas_train.py:137):
    returns the layer's four output streams ``rnd``-rounded, (h, 4N),
    and its (t | z1 | z11 | z2) block, unrounded, for the backward.
    The first layer (``z1row`` given) takes the normalised points and
    the constant tangent rows."""
    if z1row is not None:
        zv = wt @ a_cat + b
        z1 = z1row.expand_as(zv)
        z11 = torch.zeros_like(zv)
        z2 = z2row.expand_as(zv)
    else:
        Z = wt @ a_cat
        zv = Z[:, :n] + b
        z1, z11, z2 = Z[:, n:2 * n], Z[:, 2 * n:3 * n], Z[:, 3 * n:]
    t = torch.tanh(zv)
    sp = 1.0 - t * t
    spp = -2.0 * t * sp
    a_out = torch.cat([t, sp * z1, spp * z1 * z1 + sp * z11, sp * z2], dim=1)
    return rnd(a_out), torch.cat([t, z1, z11, z2], dim=1)


def _forward(a0, z1row, z2row, wt, rnd: Callable, save: bool):
    """The hidden stack and output layer (``_run_forward``,
    pallas_train.py:203): returns the output streams U (n_out, 4N),
    bias on the value columns, the last hidden layer's output streams,
    and with ``save`` each hidden layer's ``rnd``-rounded saved block."""
    n = a0.shape[1]
    n_hidden = len(wt) // 2 - 1
    a_cat, blk = _layer_fwd(wt[0], wt[1], a0, n, rnd, z1row, z2row)
    saved = [rnd(blk)] if save else None
    for l in range(1, n_hidden):
        a_cat, blk = _layer_fwd(wt[2 * l], wt[2 * l + 1], a_cat, n, rnd)
        if save:
            saved.append(rnd(blk))
    U = wt[-2] @ a_cat
    U = torch.cat([U[:, :n] + wt[-1], U[:, n:]], dim=1)
    return U, a_cat, saved


def _layer_bwd(wt, blk, g_cat, n: int, rnd: Callable, inputs: bool = True):
    """Backward of one layer's recombination (``_layer_bwd``,
    pallas_train.py:170) from its saved block and its output adjoints
    ``g_cat``: the ``rnd``-rounded pre-activation adjoints gZ (h, 4N)
    and, with ``inputs``, the adjoints of the layer's inputs."""
    t, z1, z11, z2 = (blk[:, k * n:(k + 1) * n] for k in range(4))
    g0, g1, g2, g3 = (g_cat[:, k * n:(k + 1) * n] for k in range(4))
    sp = 1.0 - t * t
    spp = -2.0 * t * sp
    gt = (g0 + g1 * (-2.0 * t * z1)
          + g2 * ((6.0 * t * t - 2.0) * z1 * z1 - 2.0 * t * z11)
          + g3 * (-2.0 * t * z2))
    gZ = rnd(torch.cat([sp * gt, g1 * sp + g2 * (2.0 * spp * z1), g2 * sp,
                        g3 * sp], dim=1))
    return gZ, (wt.t() @ gZ if inputs else None)


def _remat(blk, n: int, rnd: Callable):
    """A layer's output streams rebuilt from its saved block."""
    t, z1, z11, z2 = (blk[:, k * n:(k + 1) * n] for k in range(4))
    sp = 1.0 - t * t
    spp = -2.0 * t * sp
    return rnd(torch.cat([t, sp * z1, spp * z1 * z1 + sp * z11, sp * z2],
                         dim=1))


def _backward(wt, saved, a0, a_cat, gU, gb_out, rnd: Callable):
    """From the output adjoints ``gU`` (n_out, 4N) back through every
    layer (``_run_backward``, pallas_train.py:224): ``(gwt, gz1row,
    gz2row)``.  ``gb_out`` are the value adjoints the output bias sums."""
    n = a0.shape[1]
    L = len(wt) // 2 - 1
    g = [None] * len(wt)
    g[2 * L] = gU @ a_cat.t()
    g[2 * L + 1] = gb_out.sum(dim=1, keepdim=True)
    g_cat = wt[2 * L].t() @ gU
    for l in range(L - 1, 0, -1):
        gZ, g_cat = _layer_bwd(wt[2 * l], saved[l], g_cat, n, rnd)
        g[2 * l] = gZ @ _remat(saved[l - 1], n, rnd).t()
        g[2 * l + 1] = gZ[:, :n].sum(dim=1, keepdim=True)
    gZ, _ = _layer_bwd(wt[0], saved[0], g_cat, n, rnd, inputs=False)
    g[0] = gZ[:, :n] @ a0.t()
    g[1] = gZ[:, :n].sum(dim=1, keepdim=True)
    return (g, gZ[:, n:2 * n].sum(dim=1, keepdim=True),
            gZ[:, 3 * n:].sum(dim=1, keepdim=True))


def explicit_loss_grad(head: Callable, a0, z1row, z2row, wt_args,
                       rnd: Callable = _identity, grads: bool = True,
                       rounded_bias: bool = True):
    """A fused loss with the TPU kernel's explicit backward.  The inputs
    are ``rnd``-rounded once, as the TPU wrappers cast them
    (pallas_train.py:747-752).  ``head(U) -> (loss, gU, extras)`` is the
    misfit on the output streams, in float32; gU is rounded before the
    backward, and the output bias sums the rounded value adjoints
    (``rounded_bias``, the Burgers kernels) or the unrounded ones (the
    Schrödinger kernel).  Returns the loss alone without ``grads``,
    else ``(loss, gwt, gz1row, gz2row, *extras)``."""
    a0, z1row, z2row = rnd(a0), rnd(z1row), rnd(z2row)
    wt = [rnd(w) for w in wt_args]
    U, a_cat, saved = _forward(a0, z1row, z2row, wt, rnd, save=grads)
    loss, gU, extras = head(U)
    if not grads:
        return loss
    n = a0.shape[1]
    gUr = rnd(gU)
    gb = gUr[:, :n] if rounded_bias else gU[:, :n]
    gwt, gz1row, gz2row = _backward(wt, saved, a0, a_cat, gUr, gb, rnd)
    return (loss, gwt, gz1row, gz2row, *extras)


def _burgers_head(aux, nu):
    """The inference misfit: U -> (loss, gU, ())."""
    target, w, d = aux[0:1], aux[1:2], aux[2:3]
    e = 1.0 - d

    def head(U):
        n = U.shape[1] // 4
        u, u_x, u_xx, u_t = (U[:, k * n:(k + 1) * n] for k in range(4))
        f = d * (u - target) + e * (u_t + u * u_x - nu * u_xx)
        g_f = 2.0 * w * f
        gU = torch.cat([g_f * (d + e * u_x), g_f * e * u, -nu * g_f * e,
                        g_f * e], dim=1)
        return torch.sum(w * f * f), gU, ()

    return head


def _burgers_ide_head(aux, lam):
    """The identification misfit: U -> (loss, gU, (glam,)), glam =
    (A1, A2)."""
    target, w_d, w_f = aux[0:1], aux[1:2], aux[2:3]

    def head(U):
        n = U.shape[1] // 4
        u, u_x, u_xx, u_t = (U[:, k * n:(k + 1) * n] for k in range(4))
        f = u_t + lam[0] * u * u_x - lam[1] * u_xx
        e = u - target
        g_f = 2.0 * w_f * f
        g_d = 2.0 * w_d * e
        glam = torch.stack([torch.sum(g_f * u * u_x), torch.sum(g_f * u_xx)])
        gU = torch.cat([g_d + g_f * lam[0] * u_x, g_f * lam[0] * u,
                        -lam[1] * g_f, g_f], dim=1)
        return torch.sum(w_d * e * e + w_f * f * f), gU, (glam,)

    return head


def burgers_loss_plain(a0, aux, z1row, z2row, wt_args, nu) -> torch.Tensor:
    """The fused inference loss in plain torch ops (differentiable)."""
    U, _, _ = _forward(a0, z1row, z2row, wt_args, _identity, save=False)
    return _burgers_head(aux, nu)(U)[0]


def _value_and_grads(fn, xs):
    """``fn(*xs)`` and its gradient with respect to every ``xs``."""
    with torch.enable_grad():
        xs = [a.detach().requires_grad_(True) for a in xs]
        loss = fn(*xs)
        grads = torch.autograd.grad(loss, xs)
    return loss.detach(), list(grads)


def burgers_loss_grad_plain(a0, aux, z1row, z2row, wt_args, nu):
    """Loss and gradients of :func:`burgers_loss_plain` by autograd."""
    loss, g = _value_and_grads(
        lambda *x: burgers_loss_plain(a0, aux, x[-2], x[-1], x[:-2], nu),
        [*wt_args, z1row, z2row])
    return loss, g[:-2], g[-2], g[-1]


def burgers_loss_grad_bf16_plain(a0, aux, z1row, z2row, wt_args, nu):
    """Plain version of ``burgers_loss_grad_bf16``."""
    return explicit_loss_grad(_burgers_head(aux, nu), a0, z1row, z2row,
                              wt_args, round_bf16)


def burgers_loss_bf16_plain(a0, aux, z1row, z2row, wt_args, nu):
    """Plain version of ``burgers_loss_bf16``."""
    return explicit_loss_grad(_burgers_head(aux, nu), a0, z1row, z2row,
                              wt_args, round_bf16, grads=False)


def burgers_ide_loss_plain(a0, aux, lam, z1row, z2row, wt_args) -> torch.Tensor:
    """The fused identification loss in plain torch ops; ``lam`` =
    (lambda1, exp(log_lambda2))."""
    U, _, _ = _forward(a0, z1row, z2row, wt_args, _identity, save=False)
    return _burgers_ide_head(aux, lam)(U)[0]


def burgers_ide_loss_grad_plain(a0, aux, lam, z1row, z2row, wt_args):
    """Loss, net gradients and glam = (A1, A2) by autograd.  With
    g_f = 2 w_f f, dL/dlambda1 = sum g_f u u_x = A1 and
    dL/d(e^lambda2) = -sum g_f u_xx = -A2."""
    loss, g = _value_and_grads(
        lambda *x: burgers_ide_loss_plain(a0, aux, x[-1], x[-3], x[-2],
                                          x[:-3]),
        [*wt_args, z1row, z2row, lam])
    glam = g[-1] * torch.tensor([1.0, -1.0], dtype=lam.dtype, device=lam.device)
    return loss, g[:-3], g[-3], g[-2], glam


def burgers_ide_loss_grad_bf16_plain(a0, aux, lam, z1row, z2row, wt_args):
    """Plain version of ``burgers_ide_loss_grad_bf16`` (``lam`` stays
    float32, as on the TPU)."""
    return explicit_loss_grad(_burgers_ide_head(aux, lam), a0, z1row, z2row,
                              wt_args, round_bf16)


def burgers_ide_loss_bf16_plain(a0, aux, lam, z1row, z2row, wt_args):
    """Plain version of ``burgers_ide_loss_bf16``."""
    return explicit_loss_grad(_burgers_ide_head(aux, lam), a0, z1row, z2row,
                              wt_args, round_bf16, grads=False)


def burgers_sse_plain(a0, z1row, z2row, wt_args, nu) -> torch.Tensor:
    """The v1 residual SSE, sum of f^2 over the points, in plain torch
    ops (differentiable)."""
    U, _, _ = _forward(a0, z1row, z2row, wt_args, _identity, save=False)
    n = a0.shape[1]
    u, u_x, u_xx, u_t = (U[:, k * n:(k + 1) * n] for k in range(4))
    f = u_t + u * u_x - nu * u_xx
    return torch.sum(f * f)


def burgers_sse_grad_plain(a0, z1row, z2row, wt_args, nu):
    """SSE and gradients of :func:`burgers_sse_plain` by autograd."""
    loss, g = _value_and_grads(
        lambda *x: burgers_sse_plain(a0, x[-2], x[-1], x[:-2], nu),
        [*wt_args, z1row, z2row])
    return loss, g[:-2], g[-2], g[-1]


# ---------------------------------------------------------------------------
# CUDA launches (shared with pinn_torch.ops.fused_schrodinger)
# ---------------------------------------------------------------------------

def _widths(a0, wt_args) -> List[int]:
    return [a0.shape[0]] + [wt_args[2 * l].shape[0]
                            for l in range(len(wt_args) // 2)]


def _check_inputs(a0, aux, z1row, z2row, wt_args, n_out: int = 1,
                  extra=()) -> None:
    """What the CUDA launch checks before it touches the card.  ``aux``
    may be None (kernels without aux rows); ``extra`` are further
    float32 inputs on the same device (the ide kernels' ``lam``).  The
    bf16-stream kernels take the same float32 inputs (they round them
    as they load them), so there is no second packing to check."""
    with trace.span("loss.prep"):
        dev = a0.device
        n = a0.shape[1] if a0.dim() == 2 else -1
        if a0.dim() != 2 or a0.shape[0] != 2 or n < 1:
            raise ValueError(f"a0 must be (2, N) with N >= 1, got {tuple(a0.shape)}")
        if aux is not None and tuple(aux.shape) != (3, n):
            raise ValueError(f"aux must be (3, {n}), got {tuple(aux.shape)}")
        if len(wt_args) < 4 or len(wt_args) % 2:
            raise ValueError("wt_args must be [Wt, b] per layer, >= 2 layers")
        h_in = 2
        for l in range(len(wt_args) // 2):
            wt, b = wt_args[2 * l], wt_args[2 * l + 1]
            if wt.dim() != 2 or wt.shape[1] != h_in or tuple(b.shape) != (wt.shape[0], 1):
                raise ValueError(f"layer {l}: Wt {tuple(wt.shape)} / b "
                                 f"{tuple(b.shape)} do not chain from width {h_in}")
            h_in = wt.shape[0]
        if h_in != n_out:
            raise ValueError(f"these kernels need {n_out} output(s), got {h_in}")
        h1 = wt_args[0].shape[0]
        for name, z in (("z1row", z1row), ("z2row", z2row)):
            if tuple(z.shape) != (h1, 1):
                raise ValueError(f"{name} must be ({h1}, 1), got {tuple(z.shape)}")
        tensors = [a for a in (a0, aux, z1row, z2row, *wt_args, *extra)
                   if a is not None]
        for a in tensors:
            if a.device != dev:
                raise ValueError(f"all inputs must be on {dev}, got {a.device}")
            if a.dtype != torch.float32:
                raise TypeError(f"the CUDA kernels take float32, got {a.dtype}")
        for name, a in (("a0", a0), ("aux", aux), *(("lam", e) for e in extra)):
            if a is not None and not a.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def _pack(z1row, z2row, wt_args) -> torch.Tensor:
    return torch.cat([a.reshape(-1) for a in (*wt_args, z1row, z2row)])


def _sizes(lib, sizes_fn: str, widths: Sequence[int], limits: str) -> Tuple[int, int]:
    arr = (ctypes.c_int * len(widths))(*widths)
    n_weights, ws_rows = ctypes.c_int(0), ctypes.c_int(0)
    err = getattr(lib, sizes_fn)(arr, len(widths) - 1,
                                 ctypes.byref(n_weights), ctypes.byref(ws_rows))
    if err:
        raise ValueError(f"layer widths {list(widths)} are not supported by "
                         f"the CUDA kernels ({limits})")
    return n_weights.value, ws_rows.value


def _unpack(out: torch.Tensor, z1row, z2row, wt_args, n_extra: int = 0):
    """Split ``out`` = [loss, grad of wpack, extras] into the kernel's
    outputs ``(loss, gwt, gz1row, gz2row[, extras])``."""
    with trace.span("loss.assemble"):
        shapes = [a.shape for a in (*wt_args, z1row, z2row)]
        sizes = [int(np.prod(s)) for s in shapes]
        parts = torch.split(out[1:], sizes + [n_extra])
        grads = [p.view(s) for p, s in zip(parts, shapes)]
        res = (out[0], grads[:-2], grads[-2], grads[-1])
        return res + (parts[-1],) if n_extra else res


def _on_cuda(a0) -> bool:
    if a0.device.type == "cpu":
        return False
    if a0.device.type != "cuda":
        raise ValueError(f"unsupported device {a0.device}")
    return True


def _entry(name: str, bf16: bool) -> str:
    """The C entry point of kernel ``name`` for the stream type."""
    return name + "_bf16" if bf16 else name


def _takes_ws(name: str, n_in: int) -> bool:
    """Whether the C entry ``name`` takes a workspace between its first
    ``n_in`` arguments (a0 to the scalars) and partials, out, stream:
    read from its signature in ``_build.SIGNATURES``."""
    return len(_build.SIGNATURES[name]) == n_in + 4


def launch(name: str, sizes_fn: str, limits: str, a0, lead, z1row, z2row,
           wt_args, scalars=(), grads: bool = True, n_extra: int = 0,
           bf16: bool = False):
    """Allocate scratch and output with ``torch.empty`` and launch the
    C entry point ``name`` on the current stream of ``a0``'s device; no
    synchronisation.  The call is ``name(a0, *lead, wpack, widths,
    n_layers, n_pts, *scalars, [ws,] partials, out, stream)``, ws where
    the entry's signature has it (:func:`_takes_ws`); ``bf16`` gives ws
    bf16 elements (the ``_bf16`` entry points).  Returns the
    output buffer: [loss, grad of wpack, n_extra extras] with
    ``grads``, else [loss].  The caller has run :func:`_check_inputs`.
    Counts ``launch.<name>`` (``pinn_torch.utils.trace``)."""
    with trace.span("loss.prep"):
        lib = _build.library().lib
        widths = _widths(a0, wt_args)
        n_weights, ws_rows = _sizes(lib, sizes_fn, widths, limits)
        n = a0.shape[1]
        rows = -(-n // TILE)
        wpack = _pack(z1row, z2row, wt_args)

        def buf(size, dtype=torch.float32):
            return torch.empty(size, dtype=dtype, device=a0.device)

        cols = 1 + n_weights + n_extra if grads else 1
        # per-tile partials with the scratch of their sum after them
        partials = buf(rows * cols + lib.pt_reduce_scratch(rows, cols))
        if grads:   # saved activations, partials, their sums
            ws_dtype = torch.bfloat16 if bf16 else torch.float32
            bufs = (partials, buf(cols))
            if _takes_ws(name, 5 + len(lead) + len(scalars)):
                bufs = (buf(ws_rows * rows * TILE, ws_dtype),) + bufs
        else:       # partial losses, their sum
            bufs = (partials, buf(1))
    with trace.span("loss.launch"), torch.cuda.device(a0.device):
        err = getattr(lib, name)(
            a0.data_ptr(), *(t.data_ptr() for t in lead), wpack.data_ptr(),
            (ctypes.c_int * len(widths))(*widths), len(widths) - 1, n,
            *scalars, *(t.data_ptr() for t in bufs),
            torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, name)
    trace.count("launch." + name)
    return bufs[-1]


_BURGERS_LIMITS = "input 2, output 1, at most 15 hidden layers of width <= 64"

RB_ENTRY = "burgers_loss_grad_rb"
RB_WIDTH = _build.c_define("burgers_train.cu", "BURGERS_RB_WIDTH")


def loss_grad_entry(a0, wt_args, bf16: bool = False) -> str:
    """The C entry that :func:`burgers_loss_grad` launches on CUDA
    tensors: ``RB_ENTRY`` for float32 streams where every hidden layer
    has width ``RB_WIDTH``, else ``burgers_loss_grad`` (``_bf16`` with
    ``bf16``).  The point count does not enter: on an H100 the
    register-blocked kernel was the faster from N = 1,000 (32 tiles) to
    N = 1,000,100 (PERF.md, row 1)."""
    if not bf16 and all(w == RB_WIDTH for w in _widths(a0, wt_args)[1:-1]):
        return RB_ENTRY
    return _entry("burgers_loss_grad", bf16)


def burgers_loss_grad(a0, aux, z1row, z2row, wt_args, nu, bf16: bool = False):
    """Loss and gradients ``(loss, gwt, gz1row, gz2row)``: the CUDA
    kernel (:func:`loss_grad_entry`'s) for CUDA tensors, its plain
    version for CPU tensors."""
    if not _on_cuda(a0):
        plain = burgers_loss_grad_bf16_plain if bf16 else burgers_loss_grad_plain
        return plain(a0, aux, z1row, z2row, wt_args, nu)
    _check_inputs(a0, aux, z1row, z2row, wt_args)
    name = loss_grad_entry(a0, wt_args, bf16)
    out = launch(name, "burgers_train_sizes", _BURGERS_LIMITS, a0, [aux],
                 z1row, z2row, wt_args, [float(nu)], bf16=bf16)
    return _unpack(out, z1row, z2row, wt_args)


def burgers_loss(a0, aux, z1row, z2row, wt_args, nu,
                 bf16: bool = False) -> torch.Tensor:
    """The loss alone (0-d): the CUDA kernel (``burgers_loss[_bf16]``)
    for CUDA tensors, its plain version for CPU tensors."""
    if not _on_cuda(a0):
        plain = burgers_loss_bf16_plain if bf16 else burgers_loss_plain
        return plain(a0, aux, z1row, z2row, wt_args, nu)
    _check_inputs(a0, aux, z1row, z2row, wt_args)
    name = _entry("burgers_loss", bf16)
    out = launch(name, "burgers_train_sizes", _BURGERS_LIMITS, a0, [aux],
                 z1row, z2row, wt_args, [float(nu)], grads=False)
    return out[0]


def burgers_ide_loss_grad(a0, aux, lam, z1row, z2row, wt_args,
                          bf16: bool = False):
    """Loss, gradients and (A1, A2): ``(loss, gwt, gz1row, gz2row,
    glam)``; the CUDA kernel (``burgers_ide_loss_grad[_bf16]``) for
    CUDA tensors, its plain version for CPU tensors."""
    if not _on_cuda(a0):
        plain = (burgers_ide_loss_grad_bf16_plain if bf16
                 else burgers_ide_loss_grad_plain)
        return plain(a0, aux, lam, z1row, z2row, wt_args)
    _check_inputs(a0, aux, z1row, z2row, wt_args, extra=(lam,))
    name = _entry("burgers_ide_loss_grad", bf16)
    out = launch(name, "burgers_train_sizes", _BURGERS_LIMITS, a0,
                 [aux, lam], z1row, z2row, wt_args, n_extra=2, bf16=bf16)
    return _unpack(out, z1row, z2row, wt_args, n_extra=2)


def burgers_ide_loss(a0, aux, lam, z1row, z2row, wt_args,
                     bf16: bool = False) -> torch.Tensor:
    """The identification loss alone (0-d)."""
    if not _on_cuda(a0):
        plain = burgers_ide_loss_bf16_plain if bf16 else burgers_ide_loss_plain
        return plain(a0, aux, lam, z1row, z2row, wt_args)
    _check_inputs(a0, aux, z1row, z2row, wt_args, extra=(lam,))
    name = _entry("burgers_ide_loss", bf16)
    out = launch(name, "burgers_train_sizes", _BURGERS_LIMITS, a0,
                 [aux, lam], z1row, z2row, wt_args, grads=False)
    return out[0]


def burgers_sse_grad(a0, z1row, z2row, wt_args, nu):
    """v1 SSE and gradients ``(sse, gwt, gz1row, gz2row)``: the CUDA
    kernel ``burgers_sse_grad`` for CUDA tensors, its plain version for
    CPU tensors."""
    if not _on_cuda(a0):
        return burgers_sse_grad_plain(a0, z1row, z2row, wt_args, nu)
    _check_inputs(a0, None, z1row, z2row, wt_args)
    out = launch("burgers_sse_grad", "burgers_train_sizes", _BURGERS_LIMITS,
                 a0, [], z1row, z2row, wt_args, [float(nu)])
    return _unpack(out, z1row, z2row, wt_args)


def burgers_sse(a0, z1row, z2row, wt_args, nu) -> torch.Tensor:
    """The v1 SSE alone (0-d): the CUDA kernel ``burgers_sse`` for CUDA
    tensors, its plain version for CPU tensors."""
    if not _on_cuda(a0):
        return burgers_sse_plain(a0, z1row, z2row, wt_args, nu)
    _check_inputs(a0, None, z1row, z2row, wt_args)
    out = launch("burgers_sse", "burgers_train_sizes", _BURGERS_LIMITS, a0,
                 [], z1row, z2row, wt_args, [float(nu)], grads=False)
    return out[0]


# ---------------------------------------------------------------------------
# The differentiable losses
# ---------------------------------------------------------------------------

def _pairs(net) -> Params:
    return [(net[i], net[i + 1]) for i in range(0, len(net), 2)]


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


class _FusedBurgersLoss(torch.autograd.Function):
    """Forward launches the loss+grad kernel and stashes the gradients;
    backward is a scalar rescale by ``grad_output`` (as ``loss_bwd``
    in the JAX package)."""

    @staticmethod
    def forward(ctx, a0, aux, vx, vt, nu, bf16, *net):
        params = _pairs(net)
        z1row, z2row, wt_args = _prep(params, vx, vt)
        loss, gwt, gz1row, gz2row = burgers_loss_grad(a0, aux, z1row, z2row,
                                                      wt_args, nu, bf16)
        ctx.save_for_backward(*_assemble_net_grads(params, gwt, gz1row,
                                                   gz2row, vx, vt))
        return loss

    @staticmethod
    def backward(ctx, g):
        return (None,) * 6 + tuple(g * gr for gr in ctx.saved_tensors)


def make_burgers_loss(lb, ub, nu: float, stream_dtype=None):
    """``loss(params, batch) = mse(u - u_pred) + mse(u_t + u u_x - nu
    u_xx)`` with data and collocation points in one kernel stream.

    With gradients wanted (grad mode on and a parameter that requires
    grad) one ``burgers_loss_grad`` launch gives the loss and every
    gradient; otherwise (``torch.no_grad()``, line-search trials, log
    evaluations) one ``burgers_loss`` launch gives the loss.
    ``stream_dtype="bfloat16"`` takes the ``_bf16`` kernels (bf16
    streams, f32 accumulation: warmup-grade precision); the parameters,
    batch and gradients stay float32.
    """
    bf16 = _check_stream_dtype(stream_dtype)
    nu = float(nu)
    lb_np = np.asarray(lb, np.float32)
    ub_np = np.asarray(ub, np.float32)
    consts = {}

    def loss(params: Params, batch) -> torch.Tensor:
        with trace.span("loss"):
            dev = batch["X_f"].device
            if dev not in consts:
                consts[dev] = _tangents(lb_np, ub_np, dev)
            lb_t, ub_t, vx, vt = consts[dev]
            a0, aux = _prep_points(batch, lb_t, ub_t)
            net = leaves(params)
            if _wants_grad(net):
                return _FusedBurgersLoss.apply(a0, aux, vx, vt, nu, bf16, *net)
            z1row, z2row, wt_args = _prep(params, vx, vt)
            return burgers_loss(a0, aux, z1row, z2row, wt_args, nu, bf16)

    return loss


class _FusedBurgersIdeLoss(torch.autograd.Function):
    """Forward launches the identification loss+grad kernel; backward
    is a scalar rescale of the stashed gradients, with the lambda
    adjoints chained through the exp reparameterisation."""

    @staticmethod
    def forward(ctx, a0, aux, vx, vt, bf16, lambda1, log_lambda2, *net):
        params = _pairs(net)
        lam = _lam(lambda1, log_lambda2)
        z1row, z2row, wt_args = _prep(params, vx, vt)
        loss, gwt, gz1row, gz2row, glam = burgers_ide_loss_grad(
            a0, aux, lam, z1row, z2row, wt_args, bf16)
        g_l1 = glam[0:1].reshape(lambda1.shape)
        g_logl2 = (-glam[1:2] * lam[1:2]).reshape(log_lambda2.shape)
        ctx.save_for_backward(g_l1, g_logl2,
                              *_assemble_net_grads(params, gwt, gz1row,
                                                   gz2row, vx, vt))
        return loss

    @staticmethod
    def backward(ctx, g):
        return (None,) * 5 + tuple(g * gr for gr in ctx.saved_tensors)


def make_burgers_ide_loss(lb, ub, stream_dtype=None):
    """Fused identification loss ``loss(params: IdeParams, batch)``
    with ``batch = {"X_u", "u"}``: data MSE plus residual MSE at the
    same points, residual ``u_t + lambda1 u u_x - exp(log_lambda2)
    u_xx`` with trainable coefficients.

    With gradients wanted, one ``burgers_ide_loss_grad`` launch gives
    the loss, every net gradient and both lambda adjoints; otherwise
    one ``burgers_ide_loss`` launch gives the loss.
    ``stream_dtype="bfloat16"`` takes the ``_bf16`` kernels; the lambda
    buffer, the parameters and the gradients stay float32.
    """
    bf16 = _check_stream_dtype(stream_dtype)
    lb_np = np.asarray(lb, np.float32)
    ub_np = np.asarray(ub, np.float32)
    consts = {}

    def loss(params, batch) -> torch.Tensor:
        with trace.span("loss"):
            dev = batch["X_u"].device
            if dev not in consts:
                consts[dev] = _tangents(lb_np, ub_np, dev)
            lb_t, ub_t, vx, vt = consts[dev]
            a0, aux = _prep_ide_points(batch, lb_t, ub_t)
            net = leaves(params.net)
            if _wants_grad(leaves(params)):
                return _FusedBurgersIdeLoss.apply(a0, aux, vx, vt, bf16,
                                                  params.lambda1,
                                                  params.log_lambda2, *net)
            z1row, z2row, wt_args = _prep(params.net, vx, vt)
            return burgers_ide_loss(a0, aux,
                                    _lam(params.lambda1, params.log_lambda2),
                                    z1row, z2row, wt_args, bf16)

    return loss


class _FusedBurgersSse(torch.autograd.Function):
    """Forward launches the SSE kernel; backward launches the
    SSE+grad kernel and scales its gradients by ``grad_output`` (the
    JAX ``sse_fwd``/``sse_bwd``, pallas_train.py:472-494).  The points
    get no gradient."""

    @staticmethod
    def forward(ctx, a0, vx, vt, nu, *net):
        ctx.nu = nu
        ctx.save_for_backward(a0, vx, vt, *net)
        z1row, z2row, wt_args = _prep(_pairs(net), vx, vt)
        return burgers_sse(a0, z1row, z2row, wt_args, nu)

    @staticmethod
    def backward(ctx, g):
        a0, vx, vt, *net = ctx.saved_tensors
        params = _pairs(net)
        z1row, z2row, wt_args = _prep(params, vx, vt)
        _, gwt, gz1row, gz2row = burgers_sse_grad(a0, z1row, z2row, wt_args,
                                                  ctx.nu)
        grads = _assemble_net_grads(params, gwt, gz1row, gz2row, vx, vt)
        return (None,) * 4 + tuple(g * gr for gr in grads)


def make_burgers_sse(lb, ub, nu: float):
    """Differentiable v1 ``sse(params, X_f) -> sum_i f_i^2`` with
    ``f = u_t + u u_x - nu u_xx`` at the collocation points ``X_f``.

    The forward launches ``burgers_sse``; when autograd asks for the
    gradient, the backward launches ``burgers_sse_grad``, which runs the
    forward again with the backward, as the JAX ``custom_vjp`` does.
    float32 streams only (the TPU pair takes no ``stream_dtype``).
    """
    nu = float(nu)
    lb_np = np.asarray(lb, np.float32)
    ub_np = np.asarray(ub, np.float32)
    consts = {}

    def sse(params: Params, X_f: torch.Tensor) -> torch.Tensor:
        dev = X_f.device
        if dev not in consts:
            consts[dev] = _tangents(lb_np, ub_np, dev)
        lb_t, ub_t, vx, vt = consts[dev]
        a0 = _normalise(X_f, lb_t, ub_t)
        net = leaves(params)
        if _wants_grad(net):
            return _FusedBurgersSse.apply(a0, vx, vt, nu, *net)
        z1row, z2row, wt_args = _prep(params, vx, vt)
        return burgers_sse(a0, z1row, z2row, wt_args, nu)

    return sse


def make_burgers_loss_dp(lb, ub, nu: float, mesh, axis: str = "data",
                         stream_dtype=None):
    """Data-parallel :func:`make_burgers_loss` (``make_burgers_loss_dp``,
    pinn/ops/pallas_train.py:779-841): each shard of ``mesh`` runs the
    fused loss on (``X_u``, ``u``, its rows of ``X_f``), one kernel
    launch a shard, and ``pinn_torch.parallel.dp`` sums the shards in
    shard order (then process order) and divides by the shard count D.

    Only the collocation axis shards; the N_u-point data term is
    computed on every shard.  Each shard returns ``mse_u + sse_d /
    (N_f / D)``, so the mean over shards is ``mse_u + mse_f`` up to the
    float32 summation order.  ``N_f % D == 0`` is required (the fused
    batch has no zero-weight pad rows), else ``ValueError``.  The shards
    are not padded to whole 32-point tiles: the kernels mask the edge.
    """
    from pinn_torch.parallel.dp import data_parallel
    return data_parallel(make_burgers_loss(lb, ub, nu, stream_dtype), mesh,
                         ("X_f",), axis)
