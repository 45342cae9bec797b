"""Residual evaluation: the PDE residual of a tanh MLP at many points,
one CUDA launch, no loss and no gradient.

Counterpart of ``pinn.ops.pallas_residual``, with the same signatures
less ``interpret``:

- ``burgers_residual(params, X_f, lb, ub, nu) -> (N, 1)`` replaces
  ``_residual_kernel`` (pinn/ops/pallas_residual.py:55): points-major,
  X (N, 2) and W (h_in, h_out) as the parameters hold them.
- ``burgers_residual_fmajor(params, X_f, lb, ub, nu) -> (N, 1)``
  replaces ``_residual_kernel_fmajor`` (:107): features-major, X^T
  (2, N) and W^T (h_out, h_in).
- ``schrodinger_residual(params, X_f, lb, ub) -> (f_u, f_v)``, each
  (N, 1), replaces ``_schrodinger_kernel_fmajor`` (:248).

with ``f = u_t + u u_x - nu u_xx`` for Burgers and ``f_u = u_t + 0.5
v_xx + (u^2 + v^2) v``, ``f_v = v_t - 0.5 u_xx - (u^2 + v^2) u`` for the
two-output Schrödinger net.  The entry points
(``pinn_torch/csrc/residual_eval.cu``) take the raw points and the box
(lb, ub) and normalise in the kernel, as the TPU ones do: both
Burgers layouts on ``pt_narrow.cuh``'s block-tiled eval kernel, each
with its own loads (the two give the same values bit for bit on the
same inputs), and ``schrodinger_residual`` on ``pt_tile.cuh``'s.  This
is how the port scores points: residual-based adaptive refinement
(RAR) ranks its candidate pool by |f|, and the serving example scores
its members.

Each function takes float32 only, as the TPU kernels do, and raises on
anything else.  For CPU tensors it runs its plain version (the TPU
kernel's arithmetic on tensors, normalisation included); for CUDA
tensors it launches its kernel or raises.  ``launches`` counts the CUDA
launches by entry point.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pinn_torch.ops import _build
from pinn_torch.ops.fused_train import _on_cuda, _sizes
from pinn_torch.params import Params

# Launch counts of the kernels by entry point (CUDA launches only).
launches = {"burgers_residual": 0, "burgers_residual_fmajor": 0,
            "schrodinger_residual": 0}

_LIMITS = {1: ("burgers_train_sizes",
               "input 2, output 1, at most 15 hidden layers of width <= 64"),
           2: ("schrodinger_train_sizes",
               "input 2, output 2, at most 15 hidden layers of width <= 128")}


def _box(lb, ub):
    """(lb, ub) as host numpy pairs; the functions cast them to the
    points' dtype, as the TPU wrapper's ``asarray(lb, X_f.dtype)``."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        return np.asarray(a, np.float64).reshape(2)
    return host(lb), host(ub)


def _check(params: Params, X_f: torch.Tensor, n_out: int) -> None:
    """Shapes, dtype (float32 only) and device of the inputs."""
    if X_f.dim() != 2 or X_f.shape[1] != 2 or X_f.shape[0] < 1:
        raise ValueError(f"X_f must be (N, 2) with N >= 1, got {tuple(X_f.shape)}")
    h_in = 2
    for l, (w, b) in enumerate(params):
        if w.dim() != 2 or w.shape[0] != h_in or tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"layer {l}: W {tuple(w.shape)} / b "
                             f"{tuple(b.shape)} do not chain from width {h_in}")
        h_in = w.shape[1]
    if len(params) < 2 or h_in != n_out:
        raise ValueError(f"the residual needs a net with a hidden layer and "
                         f"{n_out} output(s)")
    for a in (X_f, *(t for wb in params for t in wb)):
        if a.dtype != torch.float32:
            raise TypeError(f"the residual kernels take float32 only, got {a.dtype}")
        if a.device != X_f.device:
            raise ValueError(f"all inputs must be on {X_f.device}, got {a.device}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _streams(params: Params, X_f: torch.Tensor, lb, ub, features_major: bool):
    """The TPU kernels' forward: normalise, first-layer tangent rows
    from scale = 2/(ub - lb), the hidden stack, and the output streams
    (H, H_x, H_xx, H_t), each (N, n_out).  ``features_major`` keeps the
    activations (features, points) and multiplies by W^T, as
    ``_residual_kernel_fmajor`` does; otherwise (points, features) times
    W, as ``_residual_kernel``."""
    lb_np, ub_np = _box(lb, ub)
    dev = X_f.device
    lb_t, ub_t = (torch.as_tensor(a, dtype=X_f.dtype, device=dev)
                  for a in (lb_np, ub_np))
    scale = 2.0 / (ub_t - lb_t)
    zero = torch.zeros_like(scale[0])
    vx = torch.stack([scale[0], zero])
    vt = torch.stack([zero, scale[1]])
    a = 2.0 * (X_f - lb_t) / (ub_t - lb_t) - 1.0                 # (N, 2)
    if features_major:
        a = a.t()

        def dot(w, x):
            return w.t() @ x

        def bias(b):
            return b[:, None]
    else:
        def dot(w, x):
            return x @ w

        def bias(b):
            return b

    w, b = params[0]
    z = dot(w, a) + bias(b)
    z1 = dot(w, vx[:, None] if features_major else vx[None, :])
    z2 = dot(w, vt[:, None] if features_major else vt[None, :])
    t = torch.tanh(z)
    sp = 1.0 - t * t
    a1, a11, a2 = sp * z1, (-2.0 * t * sp) * z1 * z1, sp * z2
    for w, b in params[1:-1]:
        z = dot(w, t) + bias(b)
        z1, z11, z2 = dot(w, a1), dot(w, a11), dot(w, a2)
        t = torch.tanh(z)
        sp = 1.0 - t * t
        spp = -2.0 * t * sp
        a1, a11, a2 = sp * z1, spp * z1 * z1 + sp * z11, sp * z2
    w, b = params[-1]
    outs = (dot(w, t) + bias(b), dot(w, a1), dot(w, a11), dot(w, a2))
    return tuple(o.t() if features_major else o for o in outs)


def burgers_residual_plain(params, X_f, lb, ub, nu) -> torch.Tensor:
    """Plain version of ``burgers_residual`` (points-major)."""
    u, u_x, u_xx, u_t = _streams(params, X_f, lb, ub, features_major=False)
    return u_t + u * u_x - nu * u_xx


def burgers_residual_fmajor_plain(params, X_f, lb, ub, nu) -> torch.Tensor:
    """Plain version of ``burgers_residual_fmajor``."""
    u, u_x, u_xx, u_t = _streams(params, X_f, lb, ub, features_major=True)
    return u_t + u * u_x - nu * u_xx


def schrodinger_residual_plain(params, X_f, lb, ub):
    """Plain version of ``schrodinger_residual``: (f_u, f_v)."""
    H, _, H_xx, H_t = _streams(params, X_f, lb, ub, features_major=True)
    u, v = H[:, 0:1], H[:, 1:2]
    h2 = u * u + v * v
    f_u = H_t[:, 0:1] + 0.5 * H_xx[:, 1:2] + h2 * v
    f_v = H_t[:, 1:2] - 0.5 * H_xx[:, 0:1] - h2 * u
    return f_u, f_v


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _launch(name: str, params: Params, X: torch.Tensor, n: int, n_out: int,
            features_major: bool, lb, ub, scalars=()) -> torch.Tensor:
    """Launch entry ``name`` on the current stream of ``X``'s device (X
    is (N, 2), or (2, N) with ``features_major``); returns the (n_out,
    N) output.  No synchronisation."""
    lib = _build.library().lib
    widths = [2] + [w.shape[1] for w, _ in params]
    sizes_fn, limits = _LIMITS[n_out]
    _sizes(lib, sizes_fn, widths, limits)
    wpack = torch.cat([a.reshape(-1) for w, b in params
                       for a in ((w.t() if features_major else w), b)])
    out = torch.empty((n_out, n), dtype=torch.float32, device=X.device)
    lb_np, ub_np = _box(lb, ub)
    with torch.cuda.device(X.device):
        err = getattr(lib, name)(
            X.data_ptr(), wpack.data_ptr(), (ctypes.c_int * len(widths))(*widths),
            len(widths) - 1, n, float(lb_np[0]), float(lb_np[1]),
            float(ub_np[0]), float(ub_np[1]), *scalars, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, name)
    launches[name] += 1
    return out


def burgers_residual(params: Params, X_f: torch.Tensor, lb, ub,
                     nu: float) -> torch.Tensor:
    """Burgers residual at the points ``X_f`` (N, 2), (N, 1): the CUDA
    kernel ``burgers_residual`` for CUDA tensors, its plain version for
    CPU tensors.  float32 only."""
    _check(params, X_f, 1)
    if not _on_cuda(X_f):
        return burgers_residual_plain(params, X_f, lb, ub, nu)
    n = X_f.shape[0]
    out = _launch("burgers_residual", params, X_f.contiguous(), n, 1, False,
                  lb, ub, [float(nu)])
    return out.view(n, 1)


def burgers_residual_fmajor(params: Params, X_f: torch.Tensor, lb, ub,
                            nu: float) -> torch.Tensor:
    """Features-major Burgers residual, (N, 1): the CUDA kernel
    ``burgers_residual_fmajor`` (the points go in as X^T) for CUDA
    tensors, its plain version for CPU tensors.  float32 only."""
    _check(params, X_f, 1)
    if not _on_cuda(X_f):
        return burgers_residual_fmajor_plain(params, X_f, lb, ub, nu)
    n = X_f.shape[0]
    out = _launch("burgers_residual_fmajor", params, X_f.t().contiguous(), n,
                  1, True, lb, ub, [float(nu)])
    return out.view(n, 1)


def schrodinger_residual(params: Params, X_f: torch.Tensor, lb, ub):
    """Schrödinger residual at the points ``X_f`` -> (f_u, f_v), each
    (N, 1): the CUDA kernel ``schrodinger_residual`` for CUDA tensors,
    its plain version for CPU tensors.  float32 only."""
    _check(params, X_f, 2)
    if not _on_cuda(X_f):
        return schrodinger_residual_plain(params, X_f, lb, ub)
    n = X_f.shape[0]
    out = _launch("schrodinger_residual", params, X_f.t().contiguous(), n, 2,
                  True, lb, ub)
    return out[0].view(n, 1), out[1].view(n, 1)
