"""Flat-parameter codec over nested parameter structures.

Counterpart of ``pinn/params.py``.  Parameters are any nesting of
lists, tuples, ``NamedTuple``s and dicts whose leaves are tensors: the
inference nets are a list of ``(W, b)`` pairs in the JAX layout —
``W`` of shape (fan_in, fan_out), not ``nn.Linear``'s (out, in) — and
the identification experiments wrap such a list in an ``IdeParams``
with the PDE coefficients at its tail.  The flat order is that of
``jax.tree_util.tree_leaves`` on the JAX pytree: depth-first, sequence
items in order, NamedTuple fields in declaration order, dict entries in
sorted key order (the facade's ``wrap_training_variables``), each leaf
row-major.  So for ``(W, b)`` pairs it is W0, b0, W1, b1, ..., and for
``IdeParams`` the net's leaves then ``lambda1``, ``log_lambda2``.  A
flat vector or an npz checkpoint is therefore the same bytes on both
sides.

A sequence with a ``remake(children)`` method (the tensor-parallel
``pinn_torch.parallel.mesh.TPParams``) is rebuilt through it, so its
placement survives ``rebuild`` and ``tree_map``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in flat (``tree_leaves``) order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [a for key in sorted(tree) for a in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [a for child in tree for a in leaves(child)]
    raise TypeError(f"parameter structures hold lists, tuples, NamedTuples, "
                    f"dicts and tensors; got {type(tree).__name__}")


def rebuild(like, new_leaves: Sequence[Any]):
    """A structure shaped like ``like`` with ``new_leaves`` (in flat
    order) in place of its tensors."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        children = [build(child) for child in node]
        if _is_namedtuple(node):
            return type(node)(*children)
        if hasattr(node, "remake"):   # a placed structure keeps its placement
            return node.remake(children)
        return type(node)(children)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` applied to every tensor of ``tree``, structure kept."""
    return rebuild(tree, [fn(a) for a in leaves(tree)])


def paths(tree, prefix: str = "") -> List[str]:
    """A name per leaf in flat order, as ``jax.tree_util.keystr`` gives
    it (``[0][1]``, ``.net[0][0]``, ``.lambda1``, ``['net'][0][0]``)."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in paths(tree[key], f"{prefix}[{key!r}]")]
    if _is_namedtuple(tree):
        return [p for name, child in zip(tree._fields, tree)
                for p in paths(child, f"{prefix}.{name}")]
    return [p for i, child in enumerate(tree)
            for p in paths(child, f"{prefix}[{i}]")]


def ravel(params) -> torch.Tensor:
    """Flatten ``params`` into one 1-D tensor (differentiable)."""
    return torch.cat([a.reshape(-1) for a in leaves(params)])


def make_unravel(params) -> Callable[[torch.Tensor], Any]:
    """The inverse of :func:`ravel` for structures shaped like ``params``.

    The returned leaves are views of the flat vector, so autograd flows
    from them back to it.
    """
    shapes = [tuple(a.shape) for a in leaves(params)]
    sizes = [int(torch.Size(s).numel()) for s in shapes]

    def unravel(flat: torch.Tensor):
        parts = [p.view(s) for p, s in zip(torch.split(flat, sizes), shapes)]
        return rebuild(params, parts)

    return unravel


def ravel_with_unravel(params):
    """Convenience: ``(flat, unravel)``."""
    return ravel(params), make_unravel(params)


def num_params(params) -> int:
    return sum(a.numel() for a in leaves(params))
