"""Adam warmup phase.

Counterpart of ``pinn/optim/adam.py``: :class:`AdamRunner`, which the
Trainer's Adam phase is built on, with keras defaults — lr, beta1 and
epsilon from hp["tf_lr"]/["tf_b1"]/["tf_eps"], beta2 = 0.999, and
``tf_eps: None`` meaning the keras epsilon 1e-7.  The update is
``torch.optim.Adam``'s, which is optax.adam's rule
``p -= lr * m_hat / (sqrt(v_hat) + eps)`` (tests/test_torch_optim.py
holds the two to a float64 trajectory).

``net_dtype_cast`` is the counterpart of ``AdamRunner``'s
hp["tf_net_dtype"] wrap (pinn/optim/adam.py:52-78), with what that wrap
computes rather than what its name suggests.  The JAX loss casts every
floating leaf of the parameters and the batch to bf16, but the loss's
float32 closure constants (bounds, viscosity) promote each operation
back to float32: the loss runs in float32 arithmetic on bf16-rounded
weights and inputs (an operation on bf16 values alone, such as
``exp(log_lambda2)``, stays bf16).  Each promotion converts its bf16
operand anew, so on the way back each product's gradient of a weight
is rounded to bf16 and the products' gradients are summed in bf16
(``add_any``); the sum reaches the master weight as float32, and the
loss comes back in the master dtype.  Here the leaves reach the loss
as bf16 tensors and the port's eager model promotes per product as JAX
does (``pinn_torch.models.mlp._mm``; elementwise operations promote by
themselves): autograd casts each product's gradient to the bf16 leaf's
dtype and accumulates them in bf16.  Rounding the float32 gradient
once instead moves elements by up to 2% at [2, 20, 20, 1] (the
per-product roundings cancel), so the per-product form is what matches.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, NamedTuple

import torch

from pinn_torch import params as pcodec
from pinn_torch.utils import trace

KERAS_DEFAULT_EPS = 1e-7


def adam_from_hp(params: Iterable[torch.Tensor], hp: dict) -> torch.optim.Adam:
    """An Adam optimizer over ``params`` (leaf tensors) configured by hp."""
    eps = hp.get("tf_eps")
    if eps is None:
        eps = KERAS_DEFAULT_EPS
    return torch.optim.Adam(params, lr=hp["tf_lr"],
                            betas=(hp.get("tf_b1", 0.9), 0.999), eps=eps)


def _cast_leaves(tree, dtype: torch.dtype):
    """Every floating tensor of ``tree`` (a dict of tensors, or a
    parameter structure) cast to ``dtype`` inside the autograd graph."""
    def cast(a):
        return a.to(dtype) if a.is_floating_point() else a
    if isinstance(tree, dict):
        return {k: cast(v) for k, v in tree.items()}
    return pcodec.tree_map(cast, tree)


def net_dtype_cast(loss_fn: Callable[[Any, Any], torch.Tensor],
                   net_dtype: str) -> Callable[[Any, Any], torch.Tensor]:
    """``loss_fn`` evaluated on the parameters and batch cast to
    ``net_dtype`` (hp["tf_net_dtype"], e.g. "bfloat16"), with its value
    in the master dtype (that of the first parameter).  ``loss_fn``
    must promote as JAX does where its leaves meet float32 constants:
    the eager losses of ``pinn_torch.problems`` do."""
    dtype = getattr(torch, str(net_dtype), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"tf_net_dtype must be a floating dtype, got "
                         f"{net_dtype!r}")

    def loss(params, batch):
        master = pcodec.leaves(params)[0].dtype
        return loss_fn(_cast_leaves(params, dtype),
                       _cast_leaves(batch, dtype)).to(master)

    return loss


class AdamState(NamedTuple):
    """:class:`AdamRunner`'s optimiser state: the leaves it steps (which
    require gradients) and the ``torch.optim.Adam`` over them, whose
    moments and step count it holds.  A run advances it in place."""

    leaves: List[torch.Tensor]
    optimizer: torch.optim.Adam


class AdamRunner:
    """Adam over a parameter structure in chunks of steps, with the JAX
    class's contract (pinn/optim/adam.py:42-103).

    ``loss_fn(params, batch) -> scalar``.  ``.loss_fn`` is the loss
    actually optimised: with hp["tf_net_dtype"] set, ``loss_fn``
    wrapped by :func:`net_dtype_cast`.  ``init(params)`` returns an
    :class:`AdamState`; ``run(params, state, batch, n_steps)`` returns
    ``(params, state, losses)`` with ``losses[i]`` the loss at step i,
    before its update.  PyTorch runs eagerly, so a run is ``n_steps``
    eager steps where JAX scans them in one program, each in the span
    ``adam.step`` (``pinn_torch.utils.trace``) with the update in
    ``adam.update``.
    """

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor],
                 hp: dict):
        self.hp = hp
        if hp.get("tf_net_dtype") is not None:
            loss_fn = net_dtype_cast(loss_fn, hp["tf_net_dtype"])
        self.loss_fn = loss_fn

    def init(self, params) -> AdamState:
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in pcodec.leaves(params)]
        return AdamState(leaves, adam_from_hp(leaves, self.hp))

    def run(self, params, state: AdamState, batch, n_steps: int):
        """Advance ``n_steps`` from ``params``; returns (params, state,
        losses[n_steps]).  The parameters returned are copies, so a
        later run does not move them."""
        leaves = state.leaves
        with torch.no_grad():
            for live, a in zip(leaves, pcodec.leaves(params)):
                if a.data_ptr() != live.data_ptr():
                    live.copy_(a)
        live_params = pcodec.rebuild(params, leaves)
        opt, losses = state.optimizer, []
        for _ in range(n_steps):
            with trace.span("adam.step"):
                opt.zero_grad(set_to_none=True)
                loss = self.loss_fn(live_params, batch)
                loss.backward()
                with trace.span("adam.update"):
                    opt.step()
                losses.append(loss.detach())
        out = pcodec.rebuild(params, [a.detach().clone() for a in leaves])
        return out, state, torch.stack(losses) if losses else \
            torch.empty(0, dtype=leaves[0].dtype, device=leaves[0].device)
