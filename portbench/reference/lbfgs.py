"""L-BFGS as the configurations name it (Nocedal & Wright, Numerical
Optimization, 2nd ed., Alg. 7.4, in the form of Torch7's optim.lbfgs):

- the first direction is -g with the step t0 = min(1, 1 / sum|g|);
  later directions come from the two-loop recursion over the last m
  pairs (s, y), s = t d, y = g_new - g_old, a pair kept only where
  y.s > 1e-10, with the initial scale H0 = y.s / y.y, and start at
  t = 1;
- ``wolfe``: weak-Wolfe bisection (Lewis & Overton 2013) on a bracket
  [lo, hi] from t: where f(x + t d) > f + c1 t g.d, hi = t; else where
  g(x + t d).d < c2 g.d, lo = t; t becomes 2 lo while hi is infinite,
  else (lo + hi) / 2; at most 25 trials, each with its gradient;
- ``armijo``: halve t from t0 until f(x + t d) <= f + c1 t g.d, at most
  25 times, the trials without gradient, then one evaluation with it;
- ``none``: t0 on the first iteration, the learning rate after;
- a search that ends without sufficient decrease, or a direction with
  g.d > -1e-19, ends the run at the last iterate.

c1 = 1e-4 and c2 = 0.9.
"""

from __future__ import annotations

import torch

C1, C2, TRIALS, TOL_X = 1e-4, 0.9, 25, 1e-19


def _direction(g, pairs, hdiag):
    q = -g
    alphas = []
    for s, y in reversed(pairs):
        al = torch.dot(s, q) / torch.dot(y, s)
        q = q - al * y
        alphas.append(al)
    r = hdiag * q
    for (s, y), al in zip(pairs, reversed(alphas)):
        be = torch.dot(y, r) / torch.dot(y, s)
        r = r + (al - be) * s
    return r


def direction_from_ring(g, S, Y, k: int, head: int, hdiag: float, m: int,
                        dtype=torch.float64):
    """The two-loop direction from gradient ``g`` and a history kept as
    a ring of ``m`` rows (``S``, ``Y``) of which ``k`` are filled, the
    oldest at row ``(head - k) mod m``, with the scale ``hdiag``.  In
    ``dtype``."""
    g = g.to(dtype)
    pairs = [(S[r].to(dtype), Y[r].to(dtype))
             for r in ((head - k + j) % m for j in range(k))]
    return _direction(g, pairs, torch.tensor(hdiag, dtype=dtype))


def _search(opfunc, lossfunc, hp, x, f, g, d, gtd, first):
    """``(t, f_new, g_new, evaluations, sufficient decrease)``."""
    t = min(1.0, 1.0 / float(g.abs().sum())) if first else 1.0
    kind = hp["nt_line_search"]
    if kind == "none":
        t = t if first else float(hp["nt_lr"])
        f_t, g_t = opfunc(x + t * d)
        return t, f_t, g_t, 1, True
    if kind == "armijo":
        f_t, g_t = opfunc(x + t * d)
        if f_t <= f + C1 * t * gtd:
            return t, f_t, g_t, 1, True
        n = 0
        while not f_t <= f + C1 * t * gtd and n < TRIALS:
            t *= 0.5
            f_t = lossfunc(x + t * d)
            n += 1
        f_t, g_t = opfunc(x + t * d)
        return t, f_t, g_t, n + 2, bool(f_t <= f + C1 * t * gtd)
    if kind == "wolfe":
        lo, hi = 0.0, float("inf")
        f_t, g_t = opfunc(x + t * d)
        n = 1
        while n < TRIALS:
            decrease = f_t <= f + C1 * t * gtd
            if decrease and torch.dot(g_t, d) >= C2 * gtd:
                break
            if decrease:
                lo = t
            else:
                hi = t
            t = 2.0 * lo if hi == float("inf") else 0.5 * (lo + hi)
            f_t, g_t = opfunc(x + t * d)
            n += 1
        return t, f_t, g_t, n, bool(f_t <= f + C1 * t * gtd)
    raise ValueError(f"unknown line search {kind!r}")


def follow_flat(opfunc, lossfunc, x0: torch.Tensor, hp: dict, iters: int):
    """``iters`` iterations from the flat iterate ``x0``.
    ``opfunc(x) -> (f, g)`` and ``lossfunc(x) -> f`` in x's dtype.
    Returns the loss at x0 and after each iteration, the gradient at
    x0, the change of x over the iterations, and the evaluations
    made."""
    m = int(hp["nt_ncorr"])
    f, g = opfunc(x0)
    x, losses, first, evals = x0, [float(f)], g, 1
    pairs, hdiag, prev = [], 1.0, None
    for k in range(iters):
        if prev is not None:
            g_old, s = prev
            y = g - g_old
            ys = torch.dot(y, s)
            if ys > 1e-10:
                pairs = (pairs + [(s, y)])[-m:]
                hdiag = ys / torch.dot(y, y)
        d = -g if k == 0 else _direction(g, pairs, hdiag)
        gtd = torch.dot(g, d)
        if gtd > -TOL_X:
            break
        t, f_new, g_new, n, ok = _search(opfunc, lossfunc, hp, x, f, g, d,
                                         gtd, k == 0)
        evals += n
        if not ok:
            break
        prev = (g, t * d)
        x, f, g = x + t * d, f_new, g_new
        losses.append(float(f))
    losses += [losses[-1]] * (iters + 1 - len(losses))
    return {"losses": losses, "grad": first, "change": x - x0,
            "evals": evals}


def follow(loss_and_grad, leaves0, hp: dict, iters: int, dtype):
    """``iters`` iterations from the leaves ``leaves0``, the net in
    ``dtype`` and the iterate, gradients and history in
    ``hp["nt_vector_dtype"]`` (else ``dtype``).  ``loss_and_grad(leaves,
    grads) -> (loss, grads or None)``.  Returns the losses at x0 and
    after each iteration, the first gradient and the change of each
    leaf (float64), and the evaluations made."""
    vec = getattr(torch, hp["nt_vector_dtype"]) if hp.get("nt_vector_dtype") else dtype
    shapes = [a.shape for a in leaves0]
    sizes = [a.numel() for a in leaves0]

    def split(x):
        return [p.reshape(s) for p, s in zip(torch.split(x, sizes), shapes)]

    def opfunc(x):
        f, g = loss_and_grad(split(x.to(dtype)), True)
        return f.to(vec), torch.cat([a.reshape(-1) for a in g]).to(vec)

    def lossfunc(x):
        return loss_and_grad(split(x.to(dtype)), False)[0].to(vec)

    x0 = torch.cat([a.detach().reshape(-1) for a in leaves0]).to(dtype).to(vec)
    out = follow_flat(opfunc, lossfunc, x0, hp, iters)
    return {"losses": out["losses"], "evals": out["evals"],
            "grad": [a.double() for a in split(out["grad"])],
            "change": [a.double() for a in split(out["change"])]}
