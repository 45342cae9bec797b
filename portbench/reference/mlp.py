"""A tanh MLP and its input derivatives, carried forward layer by layer.

The net maps a point (x, t) of the box [lb, ub] to its outputs through
``a = 2 (X - lb) / (ub - lb) - 1``, tanh hidden layers and a linear
output layer; ``params`` is a list of ``(W, b)`` with ``W`` of shape
(fan_in, fan_out).  With z a layer's pre-activation and h = tanh z,

    h_x  = (1 - h^2) z_x,       h_t = (1 - h^2) z_t,
    h_xx = (1 - h^2) z_xx - 2 h (1 - h^2) z_x^2,

and the next layer's z, z_x, z_xx, z_t are the products of h, h_x,
h_xx, h_t with its W (the bias on z alone).  The first layer's z_x and
z_t are the rows of W scaled by 2 / (ub - lb), and its z_xx is 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Streams(NamedTuple):
    """Outputs and their derivatives at each point, each (B, n_out)."""

    u: torch.Tensor
    u_x: torch.Tensor
    u_xx: torch.Tensor
    u_t: torch.Tensor


def streams(params, X: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
            mm) -> Streams:
    """The net and its x, xx and t derivatives at the points ``X``
    (B, 2); ``mm`` is the precision's matrix product."""
    scale = 2.0 / (ub - lb)
    a = (X - lb) * scale - 1.0
    W, b = params[0]
    z = mm(a, W) + b
    rows = mm(torch.diag(scale), W)           # (2, fan_out): d z / d(x, t)
    z_x, z_t = rows[0:1], rows[1:2]
    z_xx = None
    n = X.shape[0]
    for W, b in params[1:]:
        h = torch.tanh(z)
        d = 1.0 - h * h
        h_x = d * z_x
        h_t = d * z_t
        h_xx = -2.0 * h * d * z_x * z_x
        if z_xx is not None:
            h_xx = h_xx + d * z_xx
        out = mm(torch.cat([h, h_x, h_xx, h_t], dim=0), W)
        z, z_x, z_xx, z_t = out[:n] + b, out[n:2 * n], out[2 * n:3 * n], out[3 * n:]
    return Streams(z, z_x, z_xx, z_t)


def value(params, X: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
          mm) -> torch.Tensor:
    """The net's outputs alone, (B, n_out)."""
    a = (X - lb) * (2.0 / (ub - lb)) - 1.0
    for W, b in params[:-1]:
        a = torch.tanh(mm(a, W) + b)
    W, b = params[-1]
    return mm(a, W) + b


def pairs(leaves):
    """``[W0, b0, W1, b1, ...]`` as ``[(W0, b0), (W1, b1), ...]``."""
    return [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]


def sum_terms(leaves, terms, grads: bool):
    """The sum of the scalar terms that ``terms(params)`` yields, and
    with ``grads`` its gradient with respect to ``leaves``, taken term
    by term so that each term's graph is freed before the next is
    built.  Returns ``(total, [grad of each leaf] or None)``."""
    leaves = [a.detach().requires_grad_(grads) for a in leaves]
    total, acc = None, None
    with torch.set_grad_enabled(grads):
        for term in terms(pairs(leaves)):
            if grads:
                gs = torch.autograd.grad(term, leaves)
                acc = list(gs) if acc is None else [x + y for x, y in zip(acc, gs)]
            term = term.detach()
            total = term if total is None else total + term
    return total, acc
