"""L-BFGS in plain Python control flow over flat tensors.

Counterpart of ``pinn/optim/lbfgs.py`` (the repo's own L-BFGS, not
``torch.optim.LBFGS``, whose stop rules and step logic differ): the
curvature-guarded (s, y) memory (``y·s > 1e-10``), initial-Hessian
scaling ``H0 = y·s / y·y``, first step ``t = min(1, 1 / Σ|g|)``, the
``none``/``armijo``/``wolfe`` step rules, restart on a non-descent
direction, the same stopping rules and reason codes, and the ``scan``
(literal two-loop) and ``matrix`` (triangular-solve) direction forms.
On CUDA tensors the ``scan`` direction is one launch of a hand-written
kernel (``pinn_torch.ops.lbfgs_direction``), on CPU tensors the eager
recursion.

Where the JAX version is one compiled ``lax.while_loop`` with masked
fixed-shape branches, this one is an ordinary loop: each branch is an
``if`` on a value read back from the device.  The iterate, gradients
and history stay on the device.  The (m, P) history ring is updated in
place (the old ring is never read again).

Loss-only evaluations (the Armijo backtracking trials) go through
``lossfunc``, which callers run under ``torch.no_grad()`` so that a
fused loss takes its loss-only kernel.

Every device value read on the host goes through :func:`_read`, which
counts it as ``lbfgs.host_reads`` (``pinn_torch.utils.trace``): an
Armijo iteration whose first trial is taken reads 7 (the memory's
curvature guard, the descent test, the first Armijo test and the four
convergence tests), a rejected first trial ``n_ls + 2`` more, the first
iteration one fewer (no memory update) and ``lbfgs_init`` one.  A
Wolfe search counts its trials after the first by the end of the
bracket that moved: ``lbfgs.wolfe.expand`` where t doubled (no upper
end yet), ``lbfgs.wolfe.bisect`` where t halved the bracket (each
counter is touched, by 0 where nothing moved, in every Wolfe search).
Each iteration counts ``lbfgs.iters`` and runs in the span ``lbfgs.step``,
with ``lbfgs.memory``, ``lbfgs.direction``, ``lbfgs.search`` (the loss
calls nested) and ``lbfgs.checks`` inside; ``lbfgs_init`` runs in
``lbfgs.init``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pinn_torch.ops.lbfgs_direction import check_args, two_loop
from pinn_torch.utils import trace

# Termination reason codes (state.reason)
RUNNING = 0
MAX_ITER = 1
GRAD_TOL = 2        # sum|g| <= tolFun
STEP_TOL = 3        # sum|t*d| <= tolX
F_TOL = 4           # |f - f_old| < tolX
NO_PROGRESS = 5     # g·d > -tolX
MAX_EVAL = 6
NON_FINITE = 7      # loss became NaN/inf (divergence guard; not in the reference)

REASON_NAMES = {
    RUNNING: "running",
    MAX_ITER: "max iterations reached",
    GRAD_TOL: "optimality condition below tolFun",
    STEP_TOL: "step size below tolX",
    F_TOL: "function value changing less than tolX",
    NO_PROGRESS: "can not make progress along direction",
    MAX_EVAL: "max nb of function evals",
    NON_FINITE: "loss non-finite — diverged; kept last finite iterate",
}


class LbfgsConfig(NamedTuple):
    """The JAX package's LbfgsConfig, field for field (see there for
    the rationale of each search and option)."""

    learning_rate: float = 1.0
    max_iter: int = 100
    n_correction: int = 50
    tol_fun: float = float(np.finfo(np.float64).eps)
    tol_x: float = 1e-19
    max_eval: int = 0  # 0 -> 1.25 * max_iter, as in the reference
    line_search: str = "none"    # "none" | "armijo" | "wolfe"
    ls_c1: float = 1e-4          # Armijo sufficient-decrease constant
    ls_c2: float = 0.9           # Wolfe curvature constant
    ls_backtracks: int = 25      # max step trials per iteration
    restart: bool = False        # clear the history on non-descent
    dir_impl: str = "scan"       # "scan" | "matrix"

    def resolved_max_eval(self) -> int:
        if self.max_eval:
            return self.max_eval
        if self.line_search == "none":
            return int(self.max_iter * 1.25)
        return self.max_iter * (self.ls_backtracks + 2)


@dataclass
class LbfgsState:
    x: torch.Tensor          # (P,) iterate
    f: torch.Tensor          # () loss at x
    g: torch.Tensor          # (P,) gradient at x
    d: torch.Tensor          # (P,) last search direction
    t: torch.Tensor          # () last step size
    f_old: torch.Tensor      # () previous loss
    g_old: torch.Tensor      # (P,) previous gradient
    S: torch.Tensor          # (m, P) step history ring (s = t*d)
    Y: torch.Tensor          # (m, P) gradient-difference ring
    hdiag: torch.Tensor      # () initial Hessian scale
    k: int                   # filled history length (<= m)
    head: int                # ring insert position
    n_iter: int              # global iteration counter
    n_evals: int             # function evaluations so far
    reason: int              # RUNNING or a termination code


# opfunc(w, batch) -> (f, g); lossfunc(w, batch) -> f
OpFunc = Callable[[torch.Tensor, Any], Tuple[torch.Tensor, torch.Tensor]]
LossFunc = Callable[[torch.Tensor, Any], torch.Tensor]


def _read(value: torch.Tensor, kind=bool):
    """``kind(value)`` of a device value (a host sync), counted."""
    trace.count("lbfgs.host_reads")
    return kind(value)


def lbfgs_init(opfunc: OpFunc, x0: torch.Tensor, config: LbfgsConfig,
               batch: Any = None) -> LbfgsState:
    """Evaluate f, g at x0 and build the zeroed state."""
    with trace.span("lbfgs.init"):
        f0, g0 = opfunc(x0, batch)
        m, p = config.n_correction, x0.shape[0]
        opts = dict(dtype=x0.dtype, device=x0.device)
        zero = torch.zeros((), **opts)
        reason = (GRAD_TOL if _read(g0.abs().sum(), float) <= config.tol_fun
                  else RUNNING)
        return LbfgsState(
            x=x0, f=f0, g=g0, d=torch.zeros((p,), **opts), t=zero,
            f_old=f0, g_old=g0,
            S=torch.zeros((m, p), **opts), Y=torch.zeros((m, p), **opts),
            hdiag=torch.ones((), **opts), k=0, head=0, n_iter=0, n_evals=1,
            reason=reason)


def _two_loop(g, S, Y, k, head, hdiag, m):
    """The literal two-loop recursion over the filled ring slots;
    logical slot j (oldest first) is ring row (head - k + j) mod m."""
    def row(j):
        return (head - k + j) % m

    q = -g
    als = []
    for j in range(k - 1, -1, -1):              # newest -> oldest
        sj, yj = S[row(j)], Y[row(j)]
        al = (1.0 / torch.dot(yj, sj)) * torch.dot(sj, q)
        q = q - al * yj
        als.append(al)
    r_vec = q * hdiag
    for j in range(k):                          # oldest -> newest
        sj, yj = S[row(j)], Y[row(j)]
        be = (1.0 / torch.dot(yj, sj)) * torch.dot(yj, r_vec)
        r_vec = r_vec + (als[k - 1 - j] - be) * sj
    return r_vec


def _two_loop_matrix(g, S, Y, k, head, hdiag, m):
    """The same direction in matrix form (pinn/optim/lbfgs.py
    ``_two_loop_matrix``): with G[a, b] = s_a·y_b over the filled slots
    in oldest-first order and R = diag(1 / G[a, a]),

        (I + R triu(G, 1)) α = R S (−g),   r0 = hdiag (−g − αᵀ Y)
        (I + R tril(Gᵀ, −1)) β = R (Y r0 + tril(Gᵀ, −1) α)

    and the direction is r0 + (α − β)ᵀ S.  The JAX version keeps all m
    rows with ρ = 0 on unfilled ones, which zeroes their α and β; here
    the unfilled rows are left out."""
    if k == 0:
        return hdiag * (-g)
    rows = [(head - k + j) % m for j in range(k)]
    Sl, Yl = S[rows], Y[rows]
    G = Sl @ Yl.T
    rho = 1.0 / torch.diagonal(G)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    A = eye + rho[:, None] * torch.triu(G, 1)
    alpha = torch.linalg.solve_triangular(
        A, (rho * (Sl @ (-g)))[:, None], upper=True, unitriangular=True)[:, 0]
    r0 = hdiag * (-g - alpha @ Yl)
    Lm = torch.tril(G.T, -1)
    B = eye + rho[:, None] * Lm
    beta = torch.linalg.solve_triangular(
        B, (rho * (Yl @ r0 + Lm @ alpha))[:, None], upper=False,
        unitriangular=True)[:, 0]
    return r0 + (alpha - beta) @ Sl


def _direction(config: LbfgsConfig, g, S, Y, k, head, hdiag, m):
    """The search direction from the ring; ``scan`` on CUDA tensors is
    one launch of ``pinn_torch.ops.lbfgs_direction.two_loop`` (which
    checks its arguments and raises where it cannot launch), on CPU
    tensors :func:`_two_loop`."""
    if config.dir_impl not in ("scan", "matrix"):
        raise ValueError(f"unknown dir_impl {config.dir_impl!r}")
    if config.dir_impl == "scan" and g.device.type == "cuda":
        return two_loop(g, S, Y, k, head, hdiag, m)
    check_args(g, S, Y, k, head, hdiag, m)
    if config.dir_impl == "matrix":
        return _two_loop_matrix(g, S, Y, k, head, hdiag, m)
    return _two_loop(g, S, Y, k, head, hdiag, m)


def _search(opfunc: OpFunc, lossfunc: LossFunc, config: LbfgsConfig,
            state: LbfgsState, batch, d, gtd, first: bool):
    """Step along ``d``: returns (t, f_new, g_new, evals, fail)."""
    x, f = state.x, state.f
    one = torch.ones((), dtype=x.dtype, device=x.device)
    g_abs_sum = state.g.abs().sum()
    t0 = torch.minimum(one, 1.0 / g_abs_sum) if first else one
    c1 = config.ls_c1

    if config.line_search == "none":
        # Reference rule: damped first step, then the fixed learning rate.
        t = t0 if first else one * config.learning_rate
        f_new, g_new = opfunc(x + t * d, batch)
        return t, f_new, g_new, 1, False

    if config.line_search == "armijo":
        # Backtrack from t0 until f(x+td) <= f + c1 t g·d; rejected
        # trials are loss-only, one gradient at the accepted step.
        f_t0, g_t0 = opfunc(x + t0 * d, batch)
        if _read(f_t0 <= f + c1 * t0 * gtd):
            return t0, f_t0, g_t0, 1, False
        t, f_t, n_ls = t0, f_t0, 0
        while not _read(f_t <= f + c1 * t * gtd) and n_ls < config.ls_backtracks:
            t = t * 0.5
            f_t = lossfunc(x + t * d, batch)
            n_ls += 1
        f_new, g_new = opfunc(x + t * d, batch)
        fail = _read(f_new > f + c1 * t * gtd)
        return t, f_new, g_new, n_ls + 2, fail

    if config.line_search == "wolfe":
        # Weak-Wolfe bisection (Lewis–Overton) on the bracket [lo, hi].
        c2 = config.ls_c2
        t = t0
        f_t, g_t = opfunc(x + t * d, batch)
        lo = torch.zeros((), dtype=x.dtype, device=x.device)
        hi = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
        n, expand = 1, 0
        while n < config.ls_backtracks:
            armijo = _read(f_t <= f + c1 * t * gtd)
            if armijo and _read(torch.dot(g_t, d) >= c2 * gtd):
                break
            hi = hi if armijo else t
            lo = t if armijo else lo
            if _read(torch.isinf(hi)):
                t, expand = 2.0 * lo, expand + 1
            else:
                t = 0.5 * (lo + hi)
            f_t, g_t = opfunc(x + t * d, batch)
            n += 1
        trace.count("lbfgs.wolfe.expand", expand)
        trace.count("lbfgs.wolfe.bisect", n - 1 - expand)
        fail = _read(f_t > f + c1 * t * gtd)
        return t, f_t, g_t, n, fail

    raise ValueError(f"unknown line_search {config.line_search!r}")


def _step(opfunc: OpFunc, config: LbfgsConfig, state: LbfgsState,
          batch: Any, lossfunc: Optional[LossFunc] = None) -> LbfgsState:
    if lossfunc is None:
        def lossfunc(w, b):
            return opfunc(w, b)[0]
    m = config.n_correction
    first = state.n_iter == 0

    # ---- memory update (skipped on the first iteration) ----
    S, Y, head, k, hdiag = state.S, state.Y, state.head, state.k, state.hdiag
    if not first:
        with trace.span("lbfgs.memory"):
            y = state.g - state.g_old
            s = state.d * state.t
            ys = torch.dot(y, s)
            if _read(ys > 1e-10):
                S[head] = s
                Y[head] = y
                head = (head + 1) % m
                k = min(k + 1, m)
                hdiag = ys / torch.dot(y, y)

    # ---- search direction ----
    if first:
        d = -state.g
    else:
        with trace.span("lbfgs.direction"):
            d = _direction(config, state.g, S, Y, k, head, hdiag, m)
    gtd = torch.dot(state.g, d)
    no_progress = _read(gtd > -config.tol_x)
    soft_restart = no_progress and config.restart and k > 0

    # ---- step size (skipped when the direction is not a descent) ----
    if no_progress:
        t = torch.zeros((), dtype=state.x.dtype, device=state.x.device)
        f_new, g_new, ls_evals, ls_fail = state.f, state.g, 0, False
    else:
        with trace.span("lbfgs.search"):
            t, f_new, g_new, ls_evals, ls_fail = _search(
                opfunc, lossfunc, config, state, batch, d, gtd, first)
    x_new = state.x + t * d
    no_progress = no_progress or ls_fail

    # ---- convergence checks on the new point ----
    n_evals = state.n_evals + ls_evals
    reason = RUNNING
    with trace.span("lbfgs.checks"):
        if _read((f_new - state.f).abs() < config.tol_x):
            reason = F_TOL
        if _read((t * d).abs().sum() <= config.tol_x):
            reason = STEP_TOL
        if _read(g_new.abs().sum() <= config.tol_fun):
            reason = GRAD_TOL
        if n_evals >= config.resolved_max_eval():
            reason = MAX_EVAL
        non_finite = not _read(torch.isfinite(f_new))
    if non_finite:
        reason = NON_FINITE
    if no_progress:
        reason = NO_PROGRESS
    if soft_restart:  # stay RUNNING with cleared history
        reason = RUNNING
        k, head = 0, 0
        hdiag = torch.ones_like(hdiag)

    new_state = LbfgsState(
        x=x_new, f=f_new, g=g_new, d=d, t=t, f_old=state.f, g_old=state.g,
        S=S, Y=Y, hdiag=hdiag, k=k, head=head, n_iter=state.n_iter + 1,
        n_evals=n_evals, reason=reason)
    if no_progress or non_finite:
        # Keep the old iterate; zero the rejected step (t = 0) so the
        # next memory update sees s = 0 and its curvature guard rejects
        # it.  d stays the two-loop direction of the state's g_old and
        # history: the direction tried, or after a soft restart -g, the
        # cleared history's.  A departure from the JAX package, which
        # zeroes d and keeps the older g_old; with s = 0 no later step
        # reads either, so iterates, losses, counts and reasons are the
        # JAX package's.
        new_state = replace(new_state, x=state.x, f=state.f, g=state.g,
                            f_old=state.f_old, t=torch.zeros_like(t),
                            d=-state.g if soft_restart else d)
    return new_state


def make_lbfgs_run(opfunc: OpFunc, config: LbfgsConfig,
                   lossfunc: Optional[LossFunc] = None):
    """Build ``run(state, batch, n_steps) -> (state, f_hist)``.

    Advances up to ``n_steps`` iterations, stopping early when the
    state leaves RUNNING; unreached slots of ``f_hist`` hold the final
    loss."""
    def run(state: LbfgsState, batch: Any, n_steps: int):
        hist = []
        while len(hist) < n_steps and state.reason == RUNNING:
            with trace.span("lbfgs.step"):
                state = _step(opfunc, config, state, batch, lossfunc)
            trace.count("lbfgs.iters")
            hist.append(state.f)
        hist += [state.f] * (n_steps - len(hist))
        return state, torch.stack(hist) if hist else state.f.new_empty((0,))

    return run


def minimize(opfunc: OpFunc, x0: torch.Tensor, config: LbfgsConfig,
             batch: Any = None, log_fn=None, log_frequency: int = 10):
    """Full optimization with ``log_fn(iteration, loss)`` called every
    ``log_frequency`` iterations.  Returns the final state."""
    state = lbfgs_init(opfunc, x0, config, batch)
    if config.max_iter == 0:
        return state
    run = make_lbfgs_run(opfunc, config)
    done = 0
    while done < config.max_iter and state.reason == RUNNING:
        chunk = min(log_frequency, config.max_iter - done)
        state, f_hist = run(state, batch, chunk)
        done += chunk
        if log_fn is not None:
            log_fn(done, _read(f_hist[-1], float))
    return state
