"""Data and tensor parallelism: meshes of devices and the placement of
points and parameters on them (``mesh``), the fixed-order data-parallel
reduction (``dp``), the tensor-parallel layer (``tp``) and
multi-process meshes over ``torch.distributed`` (``distributed``).
Counterpart of ``pinn/parallel``."""

from pinn_torch.parallel.dp import data_parallel  # noqa: F401
from pinn_torch.parallel.mesh import (  # noqa: F401
    MODEL_AXIS, Mesh, make_mesh, make_mesh_2d, pad_points_with_weights,
    replicate, shard_params_tp, shard_points)
