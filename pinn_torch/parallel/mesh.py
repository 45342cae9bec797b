"""Device meshes and the placement of points and parameters on them.

Counterpart of ``pinn/parallel/mesh.py``.  The scaling axis of a PINN
is the collocation-point axis: the residual is independent per point
and the loss is a mean, so a step splits the points over a ``data``
axis of shards and sums the shards' partial losses and gradients
(``pinn_torch.parallel.dp``).  A second, ``model`` axis splits the MLP's
features (:func:`shard_params_tp`, the forward in
``pinn_torch.parallel.tp``).

JAX's GSPMD places the arrays and inserts the ``psum``; PyTorch has
neither, so here a :class:`Mesh` is a grid of devices, data rows by
model columns, and the reductions are written out in ``dp.py`` and
``tp.py``.  A device may repeat: ``make_mesh(devices=["cpu"] * 8)`` is
the CPU tests' stand-in for eight devices, ``[cuda:0] * 4`` runs four
shards on one card.

Deviation by design: ``make_mesh(n)`` and ``make_mesh_2d`` raise when
fewer CUDA devices are visible than the mesh needs, where JAX takes
the first ones it has and silently shrinks the mesh; a run never has
fewer shards than asked.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pinn_torch import params as pcodec
from pinn_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """The shards this process drives and the axes.

    ``devices`` is one device a shard (devices may repeat), or a grid:
    rows of equal length, one row a data shard and one column a model
    shard.  A single-process mesh has the axis ``(data,)``, or
    ``(data, model)`` for a grid; a multi-process mesh
    (``distributed.make_multihost_mesh``) has ``(hosts, data)`` with
    ``n_hosts`` processes, each driving its own ``devices``, and the
    process ``group`` its reduction gathers over.

    ``grid`` holds the rows, ``devices`` every device row by row,
    ``data_devices`` the first device of each row (where a data shard's
    points and whole streams live).  ``shape`` maps each axis to its
    size, as a JAX mesh's does; ``size`` counts every device of every
    process and ``n_data`` every data shard.
    """

    def __init__(self, devices: Sequence,
                 axis_names: Tuple[str, ...] = (DATA_AXIS,),
                 n_hosts: int = 1, group=None):
        is_grid = any(isinstance(d, (list, tuple)) for d in devices)
        rows = [tuple(r) if is_grid else (r,) for r in devices]
        if not rows or not rows[0]:
            raise ValueError("a mesh needs at least one device")
        if len({len(r) for r in rows}) != 1:
            raise ValueError("the rows of a mesh must be equally long")
        want = 2 if (is_grid or group is not None) else 1
        if len(axis_names) != want or (is_grid and group is not None):
            raise ValueError(f"axis names {axis_names}: a mesh has one axis, "
                             "two for a (data, model) grid, or two when it "
                             "spans processes")
        self.grid = tuple(rows)
        self.devices = tuple(d for r in rows for d in r)
        self.data_devices = tuple(r[0] for r in rows)
        self.axis_names = tuple(axis_names)
        self.n_hosts = int(n_hosts) if group is not None else 1
        self.group = group
        if is_grid:
            sizes = (len(rows), len(rows[0]))
        elif group is not None:
            sizes = (self.n_hosts, len(rows))
        else:
            sizes = (len(rows),)
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return self.n_hosts * len(self.devices)

    @property
    def n_data(self) -> int:
        return self.n_hosts * len(self.data_devices)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices]})")


def _cuda_devices(n: int, what: str) -> List[torch.device]:
    """The first ``n`` CUDA devices; raises when fewer are visible."""
    resolve_device("cuda")   # raises when there is no card
    have = torch.cuda.device_count()
    if n < 1 or n > have:
        raise ValueError(f"{what} of {n} CUDA device(s) was asked for but "
                         f"{have} are visible (the port never shrinks a "
                         "mesh; name devices= to repeat one)")
    return [torch.device("cuda", i) for i in range(n)]


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
    n = torch.cuda.device_count() if n_devices is None else int(n_devices)
    return Mesh(_cuda_devices(n, "a mesh"), (axis,))


def make_mesh_2d(n_data: Optional[int] = None, n_model: int = 1,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 axes: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """A (data, model) mesh of ``n_data`` rows by ``n_model`` columns:
    the collocation points split over the rows, the MLP's features over
    the columns.  ``devices`` (row by row, which may repeat:
    ``["cpu"] * 8`` as 4 x 2) must be exactly ``n_data * n_model``;
    without them the first ``n_data * n_model`` CUDA devices, raising
    when fewer are visible.  ``n_data`` defaults to the device count
    over ``n_model``, as in JAX."""
    n_model = int(n_model)
    devs = None if devices is None else [resolve_device(d) for d in devices]
    have = len(devs) if devs is not None else torch.cuda.device_count()
    n_data = have // n_model if n_data is None else int(n_data)
    n = n_data * n_model
    if devs is None:
        devs = _cuda_devices(n, f"a {n_data}x{n_model} mesh")
    elif n < 1 or n != len(devs):
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n} devices but "
                         f"{len(devs)} were named")
    return Mesh([devs[r * n_model:(r + 1) * n_model] for r in range(n_data)],
                tuple(axes))


class TPParams(tuple):
    """MLP ``(W, b)`` pairs placed over a mesh's ``model`` axis.

    Each leaf is the whole logical array, as a JAX sharded array is, on
    the device of the mesh row that uses it: the flat codec, the
    optimizers, the Trainer and the checkpoints see the same leaves as
    for plain parameters.  ``specs[l]`` is layer ``l``'s ``(W spec, b
    spec)`` as the tuples of JAX's ``PartitionSpec``; ``row`` is the
    mesh row whose model devices the forward runs on
    (``pinn_torch.parallel.tp``).  ``pinn_torch.params.rebuild`` keeps
    the placement (:meth:`remake`).
    """

    def __new__(cls, pairs, mesh: Mesh, specs, axis: str = MODEL_AXIS,
                row: int = 0):
        self = super().__new__(cls, (tuple(p) for p in pairs))
        self.mesh, self.specs, self.axis, self.row = mesh, tuple(specs), \
            axis, int(row)
        return self

    def remake(self, pairs, row: Optional[int] = None) -> "TPParams":
        """New pairs with this placement (on ``row`` when given)."""
        return TPParams(pairs, self.mesh, self.specs, self.axis,
                        self.row if row is None else row)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The model shards' devices of this row, in shard order."""
        return self.mesh.grid[self.row]

    def kind(self, layer: int) -> str:
        """``"column"`` (output features split), ``"row"`` (input
        features split) or ``"replicated"``."""
        w_spec = self.specs[layer][0]
        if w_spec == (None, self.axis):
            return "column"
        if w_spec == (self.axis, None):
            return "row"
        return "replicated"


def shard_params_tp(params, mesh: Mesh, axis: str = MODEL_AXIS) -> TPParams:
    """Alternating column/row-parallel (Megatron-style) placement of an
    MLP's ``(W, b)`` pairs over the mesh's ``model`` axis, by JAX's rule
    (pinn/parallel/mesh.py:57-88): even layers split the output
    features (column-parallel: the bias splits with them and tanh stays
    local), odd layers the input features (row-parallel: the partial
    products are summed, then the bias, replicated, is added once).  A
    dimension that does not divide the axis stays replicated.  The
    leaves go whole to the mesh's first device."""
    if axis not in mesh.shape:
        raise ValueError(f"the mesh has no axis {axis!r} ({mesh.axis_names})")
    n = mesh.shape[axis]
    home = mesh.devices[0]
    specs, pairs = [], []
    for l, (w, b) in enumerate(params):
        col = l % 2 == 0
        if w.shape[1 if col else 0] % n:
            spec = ((), ())
        elif col:
            spec = ((None, axis), (axis,) if b.shape[0] % n == 0 else ())
        else:
            spec = ((axis, None), ())
        specs.append(spec)
        pairs.append((w.to(home), b.to(home)))
    return TPParams(pairs, mesh, specs, axis)


def on_row(tree, row: int):
    """``tree`` with every :class:`TPParams` in it moved to mesh row
    ``row`` (the leaves stay where they are)."""
    if isinstance(tree, TPParams):
        return tree.remake(tuple(tree), row)
    if isinstance(tree, dict):
        return {k: on_row(v, row) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [on_row(c, row) for c in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*children)
        return type(tree)(children)
    return tree


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
    """The leading axis of ``X`` cut into the mesh's local data shards,
    in shard order, each on its shard's (row's first) device (a view
    where the device is the one ``X`` lies on).  The shards must be equal: pad with
    :func:`pad_points_with_weights` otherwise."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no axis {axis!r} ({mesh.axis_names})")
    X = torch.as_tensor(X)
    d = len(mesh.data_devices)
    n = X.shape[0]
    if n % d:
        raise ValueError(f"leading dim {n} does not divide the mesh's "
                         f"{d} local shards")
    m = n // d
    return [X[i * m:(i + 1) * m].to(dev)
            for i, dev in enumerate(mesh.data_devices)]


def replicate(tree, mesh: Mesh) -> list:
    """``tree`` (a tensor, a parameter structure or a dict of tensors)
    on every data shard's device: one copy a shard, in shard order."""
    def to(dev):
        if isinstance(tree, dict):
            return {k: torch.as_tensor(v).to(dev) for k, v in tree.items()}
        return pcodec.tree_map(lambda a: a.to(dev), tree)
    return [to(dev) for dev in mesh.data_devices]
