"""Adam (Kingma & Ba, 2015) with the keras defaults the configurations
name: beta2 = 0.999 and, where ``tf_eps`` is null, epsilon = 1e-7.

    m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2,
    p = p - lr (m / (1 - b1^k)) / (sqrt(v / (1 - b2^k)) + eps)
"""

from __future__ import annotations

import torch

KERAS_EPS = 1e-7


def follow(loss_and_grad, leaves0, hp: dict, steps: int, dtype):
    """``steps`` Adam steps from ``leaves0`` in ``dtype``.
    ``loss_and_grad(leaves, grads) -> (loss, grads)``.  Returns the loss at
    each step before its update, the first gradient and each leaf's
    change over the steps (float64)."""
    lr, b1, b2 = float(hp["tf_lr"]), float(hp.get("tf_b1", 0.9)), 0.999
    eps = KERAS_EPS if hp.get("tf_eps") is None else float(hp["tf_eps"])
    p0 = [a.detach().to(dtype) for a in leaves0]
    p = [a.clone() for a in p0]
    m = [torch.zeros_like(a) for a in p]
    v = [torch.zeros_like(a) for a in p]
    losses, first = [], None
    for k in range(1, steps + 1):
        f, g = loss_and_grad(p, True)
        losses.append(float(f))
        if first is None:
            first = [x.double() for x in g]
        for i, gi in enumerate(g):
            m[i] = b1 * m[i] + (1.0 - b1) * gi
            v[i] = b2 * v[i] + (1.0 - b2) * gi * gi
            step = (m[i] / (1.0 - b1 ** k)) / (torch.sqrt(v[i] / (1.0 - b2 ** k)) + eps)
            p[i] = p[i] - lr * step
    return {"losses": losses, "grad": first,
            "change": [(a - b).double() for a, b in zip(p, p0)]}
