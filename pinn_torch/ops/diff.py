"""Generic forward-mode derivative engine (jvp compositions).

Counterpart of ``pinn/ops/diff.py``, built on ``torch.func.jvp``: the
same directional derivatives as the fused Taylor streams
(``pinn_torch.models.mlp.taylor_apply``,
``pinn_torch.problems.navierstokes.ns_taylor_apply``) for *any* batched
function, by nested jvp.  It is the architecture-agnostic oracle the
fused streams are tested against: PINN inputs are 1-3 dimensional, so
forward mode gives each directional derivative in one pass whatever the
output width.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.func import jvp


def _broadcast_tangent(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-point tangent for a shared input-space direction ``v`` (din,)."""
    return torch.as_tensor(v, dtype=X.dtype, device=X.device).expand_as(X)


def directional(f: Callable, X: torch.Tensor,
                v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f(X), df·v) for a batched function f: (N, din) -> (N, dout)."""
    return jvp(f, (X,), (_broadcast_tangent(X, v),))


def directional2(f: Callable, X: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f, df·v, d²f[v,v]) via jvp-over-jvp (forward-over-forward)."""
    tangent = _broadcast_tangent(X, v)

    def first(x):
        return jvp(f, (x,), (tangent,))

    (value, d1), (_, d11) = jvp(first, (X,), (tangent,))
    return value, d1, d11


def directional3(f: Callable, X: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """(f, df·v, d²f[v,v], d³f[v,v,v]) via jvp³ — the oracle for the
    order-3 streams (KdV's u_xxx, Navier–Stokes' psi_xxx)."""
    tangent = _broadcast_tangent(X, v)

    def first(x):
        return jvp(f, (x,), (tangent,))

    def second(x):
        return jvp(first, (x,), (tangent,))

    ((value, d1), (_, d11)), (_, (_, d111)) = jvp(second, (X,), (tangent,))
    return value, d1, d11, d111


def space_time_derivs(f: Callable, X: torch.Tensor, vx: torch.Tensor,
                      vt: Optional[torch.Tensor] = None, order: int = 2):
    """All derivatives a continuous-time PINN residual needs.

    Returns ``(value, d_x, d_xx, d_t)`` where ``d_xx`` is None for
    ``order < 2`` and ``d_t`` is None when ``vt`` is None, the output
    contract of ``pinn_torch.models.mlp.taylor_apply``.
    """
    if order >= 2:
        value, dx, dxx = directional2(f, X, vx)
    else:
        value, dx = directional(f, X, vx)
        dxx = None
    dt = directional(f, X, vt)[1] if vt is not None else None
    return value, dx, dxx, dt
