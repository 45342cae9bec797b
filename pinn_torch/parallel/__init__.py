"""Data parallelism over the collocation points: meshes of devices
(``mesh``), the fixed-order reduction (``dp``) and multi-process meshes
over ``torch.distributed`` (``distributed``).  Counterpart of
``pinn/parallel``."""

from pinn_torch.parallel.dp import data_parallel  # noqa: F401
from pinn_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, pad_points_with_weights, replicate, shard_points)
