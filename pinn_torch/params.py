"""Flat-parameter codec over a list of ``(W, b)`` tensors.

Counterpart of ``pinn/params.py``.  Parameters are a list of ``(W, b)``
pairs in the JAX layout — ``W`` of shape (fan_in, fan_out), not
``nn.Linear``'s (out, in) — and the flat order is W0, b0, W1, b1, ...
(each row-major), the order of ``jax.tree_util.tree_leaves`` on the
JAX pytree.  A flat vector or an npz checkpoint is therefore the same
bytes on both sides.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def leaves(params: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """The tensors of ``params`` in flat order (W0, b0, W1, b1, ...)."""
    return [a for pair in params for a in pair]


def ravel(params) -> torch.Tensor:
    """Flatten ``params`` into one 1-D tensor (differentiable)."""
    return torch.cat([a.reshape(-1) for a in leaves(params)])


def make_unravel(params) -> Callable[[torch.Tensor], Params]:
    """The inverse of :func:`ravel` for params shaped like ``params``.

    The returned pairs are views of the flat vector, so autograd flows
    from them back to it.
    """
    shapes = [tuple(a.shape) for a in leaves(params)]
    sizes = [int(torch.Size(s).numel()) for s in shapes]

    def unravel(flat: torch.Tensor) -> Params:
        parts = [p.view(s) for p, s in zip(torch.split(flat, sizes), shapes)]
        return [(parts[i], parts[i + 1]) for i in range(0, len(parts), 2)]

    return unravel


def ravel_with_unravel(params):
    """Convenience: ``(flat, unravel)``."""
    return ravel(params), make_unravel(params)


def num_params(params) -> int:
    return sum(a.numel() for a in leaves(params))
