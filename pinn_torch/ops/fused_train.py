"""Fused Burgers training loss: one CUDA launch for the loss and every
parameter gradient.

Counterpart of ``pinn.ops.pallas_train.make_burgers_loss``.  Data and
collocation points ride one stream with three aux rows (target, w, d):

    loss = sum_i w_i f_i^2,   f_i = d_i (u_i - target_i)
                                    + (1 - d_i)(u_t + u u_x - nu u_xx)_i

with w = 1/N_u on data points and 1/N_f on collocation points, so the
loss is mse(u - u_pred) + mse(f) exactly.

Kernels (``pinn_torch/csrc/burgers_train.cu``, built by ``_build``):

- ``burgers_loss_grad`` replaces ``_make_train_kernel``
  (pinn/ops/pallas_train.py:524): loss, all dW/db and the first-layer
  tangent-row adjoints in one launch, plus a fixed-order reduction of
  the per-tile partials.
- ``burgers_loss`` replaces ``_fwd_train_kernel`` (:576): the loss alone.

Both are bound by latency at the flagship N = 10,100 (316 warps on 132
SMs); the source note in the .cu says what the design does about the
saved activations and the cross-block sum.

Each kernel has a plain PyTorch version with the same signature
``(a0, aux, z1row, z2row, wt_args, nu) -> (loss, gwt, gz1row, gz2row)``
(the loss-only one returns the loss).  The wrappers take the plain
version only for tensors on the CPU; for CUDA tensors they launch the
kernel or raise.  The host-side prep (:func:`_prep`,
:func:`_prep_points`) and reassembly (:func:`_assemble_net_grads`)
wrap both, so the CPU tests exercise everything but the kernel body.

Layouts follow the TPU kernel: a0 (2, N) normalised points
(features-major), aux (3, N), per layer Wt (h_out, h_in) and b
(h_out, 1), z1row = (vx @ W0)[:, None], z2row = (vt @ W0)[:, None].
The CUDA kernel masks the ragged edge itself, so nothing is padded.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from pinn_torch.ops import _build
from pinn_torch.params import Params, leaves

# Launch counts of the two kernels (CUDA launches only; the plain
# versions do not count).
n_launch_loss_grad = 0
n_launch_loss = 0

TILE = 32  # points per CUDA block (burgers_train.cu PT_TILE)


# ---------------------------------------------------------------------------
# Host-side prep and reassembly (shared by the kernel and the plain path)
# ---------------------------------------------------------------------------

def _prep(params: Params, vx: torch.Tensor, vt: torch.Tensor):
    """First-layer tangent rows and the kernel's weight layout."""
    w0 = params[0][0]
    z1row = (vx @ w0)[:, None]                       # (h1, 1)
    z2row = (vt @ w0)[:, None]
    wt_args = []
    for w, b in params:
        wt_args += [w.t().contiguous(), b.reshape(-1, 1)]
    return z1row, z2row, wt_args


def _prep_points(batch, lb: torch.Tensor, ub: torch.Tensor):
    """Stack [X_u; X_f], normalise, and build the aux rows (target, w, d)."""
    X_u, u, X_f = batch["X_u"], batch["u"], batch["X_f"]
    n_u, n_f = X_u.shape[0], X_f.shape[0]
    dtype, dev = X_f.dtype, X_f.device
    X = torch.cat([X_u, X_f], dim=0)
    a0 = (2.0 * (X - lb) / (ub - lb) - 1.0).t().contiguous()   # (2, N)
    target = torch.cat([u[:, 0], torch.zeros((n_f,), dtype=dtype, device=dev)])
    w = torch.cat([torch.full((n_u,), 1.0 / n_u, dtype=dtype, device=dev),
                   torch.full((n_f,), 1.0 / n_f, dtype=dtype, device=dev)])
    d = torch.cat([torch.ones((n_u,), dtype=dtype, device=dev),
                   torch.zeros((n_f,), dtype=dtype, device=dev)])
    aux = torch.stack([target, w, d]).contiguous()             # (3, N)
    return a0, aux


def _assemble_net_grads(params: Params, gwt, gz1row, gz2row, vx, vt):
    """Kernel-layout gradients -> params layout; the tangent-row
    adjoints fold into dW0 through z1row = vx @ W0, z2row = vt @ W0."""
    grads = []
    for l, (w, b) in enumerate(params):
        gw = gwt[2 * l].t()
        gb = gwt[2 * l + 1].reshape(b.shape)
        if l == 0:
            gw = gw + torch.outer(vx, gz1row[:, 0]) + torch.outer(vt, gz2row[:, 0])
        grads += [gw, gb]
    return grads


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def burgers_loss_plain(a0, aux, z1row, z2row, wt_args, nu) -> torch.Tensor:
    """The fused loss in plain torch ops, streams stacked as the TPU
    kernel stacks them: each layer is one (h, 4N) product."""
    n = a0.shape[1]
    n_hidden = len(wt_args) // 2 - 1
    zv = wt_args[0] @ a0 + wt_args[1]
    t = torch.tanh(zv)
    sp = 1.0 - t * t
    spp = -2.0 * t * sp
    z1 = z1row.expand_as(zv)
    z2 = z2row.expand_as(zv)
    a_cat = torch.cat([t, sp * z1, spp * z1 * z1, sp * z2], dim=1)
    for l in range(1, n_hidden):
        Z = wt_args[2 * l] @ a_cat
        zv = Z[:, :n] + wt_args[2 * l + 1]
        z1, z11, z2 = Z[:, n:2 * n], Z[:, 2 * n:3 * n], Z[:, 3 * n:]
        t = torch.tanh(zv)
        sp = 1.0 - t * t
        spp = -2.0 * t * sp
        a_cat = torch.cat([t, sp * z1, spp * z1 * z1 + sp * z11, sp * z2],
                          dim=1)
    U = wt_args[-2] @ a_cat
    u = U[:, :n] + wt_args[-1]
    u_x, u_xx, u_t = U[:, n:2 * n], U[:, 2 * n:3 * n], U[:, 3 * n:]
    target, w, d = aux[0:1], aux[1:2], aux[2:3]
    e = 1.0 - d
    f = d * (u - target) + e * (u_t + u * u_x - nu * u_xx)
    return torch.sum(w * f * f)


def burgers_loss_grad_plain(a0, aux, z1row, z2row, wt_args, nu):
    """Loss and gradients of :func:`burgers_loss_plain` by autograd."""
    with torch.enable_grad():
        xs = [a.detach().requires_grad_(True)
              for a in (*wt_args, z1row, z2row)]
        loss = burgers_loss_plain(a0, aux, xs[-2], xs[-1], xs[:-2], nu)
        grads = torch.autograd.grad(loss, xs)
    return loss.detach(), list(grads[:-2]), grads[-2], grads[-1]


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _widths(a0, wt_args) -> List[int]:
    return [a0.shape[0]] + [wt_args[2 * l].shape[0]
                            for l in range(len(wt_args) // 2)]


def _check_inputs(a0, aux, z1row, z2row, wt_args) -> None:
    dev = a0.device
    n = a0.shape[1] if a0.dim() == 2 else -1
    if a0.dim() != 2 or a0.shape[0] != 2 or n < 1:
        raise ValueError(f"a0 must be (2, N) with N >= 1, got {tuple(a0.shape)}")
    if tuple(aux.shape) != (3, n):
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
    if h_in != 1:
        raise ValueError(f"the Burgers kernels need one output, got {h_in}")
    h1 = wt_args[0].shape[0]
    for name, z in (("z1row", z1row), ("z2row", z2row)):
        if tuple(z.shape) != (h1, 1):
            raise ValueError(f"{name} must be ({h1}, 1), got {tuple(z.shape)}")
    for a in (a0, aux, z1row, z2row, *wt_args):
        if a.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {a.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {a.dtype}")
    for name, a in (("a0", a0), ("aux", aux)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _pack(z1row, z2row, wt_args) -> torch.Tensor:
    return torch.cat([a.reshape(-1) for a in (*wt_args, z1row, z2row)])


def _sizes(lib, widths: Sequence[int]) -> Tuple[int, int]:
    arr = (ctypes.c_int * len(widths))(*widths)
    n_weights, ws_rows = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.burgers_train_sizes(arr, len(widths) - 1,
                                  ctypes.byref(n_weights),
                                  ctypes.byref(ws_rows))
    if err:
        raise ValueError(f"layer widths {list(widths)} are not supported by "
                         "the CUDA kernels (input 2, output 1, at most 15 "
                         "hidden layers of width <= 64)")
    return n_weights.value, ws_rows.value


def _unpack(out: torch.Tensor, z1row, z2row, wt_args):
    """Split ``out`` = [loss, grad of wpack] into the kernel's outputs."""
    shapes = [a.shape for a in (*wt_args, z1row, z2row)]
    parts = torch.split(out[1:], [int(np.prod(s)) for s in shapes])
    grads = [p.view(s) for p, s in zip(parts, shapes)]
    return out[0], grads[:-2], grads[-2], grads[-1]


def _on_cuda(a0) -> bool:
    if a0.device.type == "cpu":
        return False
    if a0.device.type != "cuda":
        raise ValueError(f"unsupported device {a0.device}")
    return True


def _launch(a0, aux, z1row, z2row, wt_args, nu, grads: bool):
    """Check the inputs, allocate scratch and output with ``torch.empty``
    and launch ``burgers_loss_grad`` (``grads``) or ``burgers_loss`` on
    the current stream of ``a0``'s device; no synchronisation.  Returns
    the output buffer: [loss, grad of wpack] or [loss]."""
    _check_inputs(a0, aux, z1row, z2row, wt_args)
    lib = _build.library().lib
    widths = _widths(a0, wt_args)
    n_weights, ws_rows = _sizes(lib, widths)
    n = a0.shape[1]
    blocks = -(-n // TILE)
    wpack = _pack(z1row, z2row, wt_args)

    def buf(size):
        return torch.empty(size, dtype=torch.float32, device=a0.device)

    if grads:   # saved activations, per-block partials, their sums
        name = "burgers_loss_grad"
        bufs = (buf(ws_rows * blocks * TILE), buf(blocks * (1 + n_weights)),
                buf(1 + n_weights))
    else:       # per-block partial losses, their sum
        name = "burgers_loss"
        bufs = (buf(blocks), buf(1))
    with torch.cuda.device(a0.device):
        err = getattr(lib, name)(
            a0.data_ptr(), aux.data_ptr(), wpack.data_ptr(),
            (ctypes.c_int * len(widths))(*widths), len(widths) - 1, n,
            float(nu), *(t.data_ptr() for t in bufs),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, name)
    return bufs[-1]


def burgers_loss_grad(a0, aux, z1row, z2row, wt_args, nu):
    """Loss and gradients ``(loss, gwt, gz1row, gz2row)``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    global n_launch_loss_grad
    if not _on_cuda(a0):
        return burgers_loss_grad_plain(a0, aux, z1row, z2row, wt_args, nu)
    out = _launch(a0, aux, z1row, z2row, wt_args, nu, grads=True)
    n_launch_loss_grad += 1
    return _unpack(out, z1row, z2row, wt_args)


def burgers_loss(a0, aux, z1row, z2row, wt_args, nu) -> torch.Tensor:
    """The loss alone (0-d): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    global n_launch_loss
    if not _on_cuda(a0):
        return burgers_loss_plain(a0, aux, z1row, z2row, wt_args, nu)
    out = _launch(a0, aux, z1row, z2row, wt_args, nu, grads=False)
    n_launch_loss += 1
    return out[0]


# ---------------------------------------------------------------------------
# The differentiable loss
# ---------------------------------------------------------------------------

class _FusedBurgersLoss(torch.autograd.Function):
    """Forward launches the loss+grad kernel and stashes the gradients;
    backward is a scalar rescale by ``grad_output`` (as ``loss_bwd``
    in the JAX package)."""

    @staticmethod
    def forward(ctx, a0, aux, vx, vt, nu, *net):
        params = [(net[i], net[i + 1]) for i in range(0, len(net), 2)]
        z1row, z2row, wt_args = _prep(params, vx, vt)
        loss, gwt, gz1row, gz2row = burgers_loss_grad(a0, aux, z1row, z2row,
                                                      wt_args, nu)
        ctx.save_for_backward(*_assemble_net_grads(params, gwt, gz1row,
                                                   gz2row, vx, vt))
        return loss

    @staticmethod
    def backward(ctx, g):
        return (None,) * 5 + tuple(g * gr for gr in ctx.saved_tensors)


def make_burgers_loss(lb, ub, nu: float, stream_dtype=None):
    """``loss(params, batch) = mse(u - u_pred) + mse(u_t + u u_x - nu
    u_xx)`` with data and collocation points in one kernel stream.

    With gradients wanted (grad mode on and a parameter that requires
    grad) one ``burgers_loss_grad`` launch gives the loss and every
    gradient; otherwise (``torch.no_grad()``, line-search trials, log
    evaluations) one ``burgers_loss`` launch gives the loss.  float32
    only, as the JAX kernel's exact path.
    """
    if stream_dtype not in (None, "float32", torch.float32):
        raise NotImplementedError(
            "stream_dtype other than float32 (the bf16-stream variant) "
            "is not ported yet")
    nu = float(nu)
    lb_np = np.asarray(lb, np.float32)
    ub_np = np.asarray(ub, np.float32)
    consts = {}

    def _consts(dev):
        if dev not in consts:
            lb_t = torch.as_tensor(lb_np, device=dev)
            ub_t = torch.as_tensor(ub_np, device=dev)
            scale = 2.0 / (ub_t - lb_t)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            vx = torch.stack([scale[0], zero])
            vt = torch.stack([zero, scale[1]])
            consts[dev] = (lb_t, ub_t, vx, vt)
        return consts[dev]

    def loss(params: Params, batch) -> torch.Tensor:
        lb_t, ub_t, vx, vt = _consts(batch["X_f"].device)
        a0, aux = _prep_points(batch, lb_t, ub_t)
        net = leaves(params)
        if torch.is_grad_enabled() and any(a.requires_grad for a in net):
            return _FusedBurgersLoss.apply(a0, aux, vx, vt, nu, *net)
        z1row, z2row, wt_args = _prep(params, vx, vt)
        return burgers_loss(a0, aux, z1row, z2row, wt_args, nu)

    return loss
