"""Device meshes and the placement of points on them.

Counterpart of ``pinn/parallel/mesh.py``.  The scaling axis of a PINN
is the collocation-point axis: the residual is independent per point
and the loss is a mean, so a step splits the points over a 1-D
``data`` axis of shards and sums the shards' partial losses and
gradients (``pinn_torch.parallel.dp``).  The parameters, a few KB, are
replicated.

JAX's GSPMD places the arrays and inserts the ``psum``; PyTorch has
neither, so here a :class:`Mesh` is an ordered tuple of devices, one a
shard, and the reduction is written out in ``dp.py``.  A device may
repeat: ``make_mesh(devices=["cpu"] * 8)`` is the CPU tests' stand-in
for eight devices, ``[cuda:0] * 4`` runs four shards on one card.

Deviation by design: ``make_mesh(n)`` raises when fewer than ``n``
CUDA devices are visible, where JAX takes the first ``n`` it has and
silently shrinks the mesh; a run never has fewer shards than asked.

The 2-D (data, model) mesh and ``shard_params_tp`` are not ported yet:
they need a tensor-parallel MLP forward with its Taylor streams.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinn_torch import params as pcodec
from pinn_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"


class Mesh:
    """The shards this process drives, in shard order, and the axes.

    ``devices`` holds one device a shard (devices may repeat).  A
    single-process mesh has the one axis ``(axis,)``; a multi-process
    mesh (``distributed.make_multihost_mesh``) has ``(hosts, data)``
    with ``n_hosts`` processes, each driving its own ``devices``, and
    the process ``group`` its reduction gathers over.  ``shape`` maps
    each axis to its size, as a JAX mesh's does; ``size`` counts every
    shard of every process.
    """

    def __init__(self, devices: Sequence[torch.device],
                 axis_names: Tuple[str, ...] = (DATA_AXIS,),
                 n_hosts: int = 1, group=None):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len(axis_names) != (1 if group is None else 2):
            raise ValueError(f"axis names {axis_names}: a mesh has one axis, "
                             "or two when it spans processes")
        self.devices = tuple(devices)
        self.axis_names = tuple(axis_names)
        self.n_hosts = int(n_hosts) if group is not None else 1
        self.group = group
        sizes = (len(self.devices),) if group is None else \
            (self.n_hosts, len(self.devices))
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return self.n_hosts * len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices]})")


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[DeviceLike]] = None,
              axis: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh: the named ``devices`` (which may repeat), else the
    first ``n_devices`` CUDA devices (``None``: all of them).  Raises
    when there is no card, or fewer than ``n_devices``."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices "
                             "were named")
        return Mesh(devs, (axis,))
    resolve_device("cuda")   # raises when there is no card
    have = torch.cuda.device_count()
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise ValueError(f"a mesh of {n} CUDA device(s) was asked for but "
                         f"{have} are visible (the port never shrinks a "
                         "mesh; name devices= to repeat one)")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


def pad_points_with_weights(X: np.ndarray, n_shards: int,
                            dtype=None) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the point axis to a multiple of ``n_shards``.

    Returns (X_padded, weights) where weights sum to 1 over real points
    and are 0 on pads, so ``sum(r**2 * w)`` equals the unpadded mean.
    (A numpy copy of the JAX package's, bit for bit.)
    """
    n = X.shape[0]
    n_pad = (-n) % n_shards
    if n_pad:
        X = np.concatenate([X, np.tile(X[-1:], (n_pad,) + (1,) * (X.ndim - 1))])
    w = np.concatenate([np.full(n, 1.0 / n), np.zeros(n_pad)])
    if dtype is not None:
        X = X.astype(dtype)
        w = w.astype(dtype)
    return X, w


def shard_points(X, mesh: Mesh, axis: str = DATA_AXIS) -> List[torch.Tensor]:
    """The leading axis of ``X`` cut into the mesh's local shards, in
    shard order, each on its shard's device (a view where the device is
    the one ``X`` lies on).  The shards must be equal: pad with
    :func:`pad_points_with_weights` otherwise."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r} ({mesh.axis_names})")
    X = torch.as_tensor(X)
    d = len(mesh.devices)
    n = X.shape[0]
    if n % d:
        raise ValueError(f"leading dim {n} does not divide the mesh's "
                         f"{d} local shards")
    m = n // d
    return [X[i * m:(i + 1) * m].to(dev) for i, dev in enumerate(mesh.devices)]


def replicate(tree, mesh: Mesh) -> list:
    """``tree`` (a tensor, a parameter structure or a dict of tensors)
    on every shard's device: one copy a shard, in shard order."""
    def to(dev):
        if isinstance(tree, dict):
            return {k: torch.as_tensor(v).to(dev) for k, v in tree.items()}
        return pcodec.tree_map(lambda a: a.to(dev), tree)
    return [to(dev) for dev in mesh.devices]
