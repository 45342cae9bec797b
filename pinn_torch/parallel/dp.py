"""The data-parallel reduction: shards' losses and gradients summed in a
fixed order.

Counterpart of what ``shard_map`` + ``psum`` (``make_burgers_loss_dp``,
pinn/ops/pallas_train.py:779-841) and GSPMD's inserted reductions (the
``tpu_mesh`` runs) do in the JAX package.  :func:`data_parallel` turns
a per-shard loss into the mesh's loss:

    loss(params, batch) = (sum over shards d of local_loss(params, batch_d)) / D

where ``batch_d`` holds shard d's rows of the ``shard_keys`` arrays and
every other array whole, and D is the number of data shards on every
process of the mesh.  On a (data, model) mesh the data shards are its
rows: shard d runs on row d's first device, with tensor-parallel
parameters (``shard_params_tp``) over row d's model devices, and the
model axis's own sums are ``pinn_torch.parallel.tp``'s.

The order of every sum is fixed, so two calls, and two processes, give
bitwise-equal values and gradients:

- Forward.  For each local shard in shard order the value and the
  parameter gradients of ``local_loss`` (``torch.autograd.grad``; a
  fused loss hands back its kernel's own gradients) are folded left to
  right on the first shard's device.  Across processes
  (``mesh.group``) each process's folded ``[value, gradients]`` vector
  is gathered (``all_gather``, never ``all_reduce``, whose order NCCL
  and gloo choose) and folded in rank order on every process.  Then the
  sum is divided by D.  The vector is KB-scale (3,021 parameters on the
  Burgers flagship, 30,802 on Schrödinger).
- Backward.  The stored gradients scaled by ``grad_output``, as the
  fused losses' ``autograd.Function``s do.
- Without gradients (``torch.no_grad()``, a line-search trial, a log
  evaluation) only the values are computed and folded: the fused
  losses then launch their loss-only kernels, once a shard.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from pinn_torch import params as pcodec
from pinn_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, on_row,
                                      shard_points)


def _fold(parts: List[torch.Tensor]) -> torch.Tensor:
    """Left-to-right sum, on the first part's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def _gather_fold(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Every process's ``tensors`` gathered and each summed in rank
    order.  They cross as one float64 vector (an exact widening) and
    are summed in their own dtypes."""
    import torch.distributed as dist

    wide = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    parts = [torch.empty_like(wide)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wide, group=group)
    sizes = [t.numel() for t in tensors]
    ranks = [[c.reshape(t.shape).to(t.dtype)
              for c, t in zip(torch.split(p, sizes), tensors)] for p in parts]
    return [_fold(list(xs)) for xs in zip(*ranks)]


def _shard_batches(batch, mesh: Mesh, shard_keys: Sequence[str],
                   axis: str) -> List[dict]:
    d = len(mesh.data_devices)
    for k in shard_keys:
        if batch[k].shape[0] % d:
            raise ValueError(
                f"batch[{k!r}] leading dim {batch[k].shape[0]} must "
                f"divide the mesh '{axis}' axis ({d}) — choose N_f "
                "as a multiple of the device count for the fused DP path")
    cuts = {k: shard_points(batch[k], mesh, axis) for k in shard_keys}
    return [{k: (cuts[k][i] if k in cuts else v.to(dev))
             for k, v in batch.items()}
            for i, dev in enumerate(mesh.data_devices)]


def _on_shard(params, i: int, mesh: Mesh):
    """``params`` for data shard ``i``: on a (data, model) mesh its
    tensor-parallel layers run on row ``i``'s model devices."""
    return on_row(params, i) if MODEL_AXIS in mesh.shape else params


def _values(local_loss, params, shards, mesh: Mesh) -> torch.Tensor:
    with torch.no_grad():
        vals = [local_loss(_on_shard(pcodec.tree_map(lambda a: a.to(dev),
                                                     params), i, mesh), b)
                for i, (b, dev) in enumerate(zip(shards, mesh.data_devices))]
    value = _fold(vals)
    if mesh.group is not None:
        value, = _gather_fold([value], mesh.group)
    return value / mesh.n_data


def _values_and_grads(local_loss, params, shards, mesh: Mesh):
    """The folded value and the folded gradients as one flat vector in
    the parameters' flat order."""
    vals, grads = [], []
    with torch.enable_grad():
        for i, (b, dev) in enumerate(zip(shards, mesh.data_devices)):
            leaves = [a.detach().to(dev).requires_grad_(True)
                      for a in pcodec.leaves(params)]
            val = local_loss(_on_shard(pcodec.rebuild(params, leaves), i,
                                       mesh), b)
            g = torch.autograd.grad(val, leaves, allow_unused=True)
            vals.append(val.detach())
            grads.append(torch.cat([(torch.zeros_like(a) if gi is None
                                     else gi).reshape(-1)
                                    for a, gi in zip(leaves, g)]))
    value, grad = _fold(vals), _fold(grads)
    if mesh.group is not None:
        value, grad = _gather_fold([value, grad], mesh.group)
    return value / mesh.n_data, grad / mesh.n_data


class _DataParallelLoss(torch.autograd.Function):
    """Forward: the folded value, the folded flat gradient stashed;
    backward: that gradient scaled by ``grad_output``, cut into the
    leaves' shapes."""

    @staticmethod
    def forward(ctx, run, *leaves):
        value, grad = run()
        ctx.save_for_backward(grad)
        ctx.shapes = [a.shape for a in leaves]
        return value

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        parts = torch.split(g * grad, [s.numel() for s in ctx.shapes])
        return (None,) + tuple(p.view(s) for p, s in zip(parts, ctx.shapes))


def data_parallel(local_loss: Callable, mesh: Mesh,
                  shard_keys: Sequence[str] = ("X_f",),
                  axis: str = DATA_AXIS) -> Callable:
    """``loss(params, batch)``: ``local_loss`` on each shard of the
    mesh, reduced as the module's docstring says.  ``batch[k]`` for
    ``k`` in ``shard_keys`` is cut along its leading axis over the
    mesh's local shards (on a multi-process mesh: this process's rows),
    which must divide it; the other arrays go whole to every shard."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r} ({mesh.axis_names})")

    def loss(params, batch) -> torch.Tensor:
        shards = _shard_batches(batch, mesh, shard_keys, axis)
        leaves = pcodec.leaves(params)
        if not (torch.is_grad_enabled() and any(a.requires_grad
                                                for a in leaves)):
            return _values(local_loss, params, shards, mesh)
        return _DataParallelLoss.apply(
            lambda: _values_and_grads(local_loss, params, shards, mesh),
            *leaves)

    return loss
