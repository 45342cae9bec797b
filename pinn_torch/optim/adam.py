"""Adam warmup phase.

Counterpart of ``pinn/optim/adam.py``: keras defaults — lr, beta1 and
epsilon from hp["tf_lr"]/["tf_b1"]/["tf_eps"], beta2 = 0.999, and
``tf_eps: None`` meaning the keras epsilon 1e-7.  The update is
``torch.optim.Adam``'s, which is optax.adam's rule
``p -= lr * m_hat / (sqrt(v_hat) + eps)`` (tests/test_torch_optim.py
holds the two to a float64 trajectory).
"""

from __future__ import annotations

from typing import Iterable

import torch

KERAS_DEFAULT_EPS = 1e-7


def adam_from_hp(params: Iterable[torch.Tensor], hp: dict) -> torch.optim.Adam:
    """An Adam optimizer over ``params`` (leaf tensors) configured by hp."""
    eps = hp.get("tf_eps")
    if eps is None:
        eps = KERAS_DEFAULT_EPS
    return torch.optim.Adam(params, lr=hp["tf_lr"],
                            betas=(hp.get("tf_b1", 0.9), 0.999), eps=eps)
