"""Multi-process meshes over ``torch.distributed``.

Counterpart of ``pinn/parallel/distributed.py``.  Several processes
(one a host, or CPU processes in the tests) form one mesh whose outer
``hosts`` axis crosses processes and whose inner ``data`` axis is each
process's own shards.  The collocation points split over both axes;
the parameters and the small data sets are the same on every process
(same seed, same numpy draws).  The loss of a multi-process mesh
(``pinn_torch.parallel.dp``) folds its local shards, gathers every
process's partial sums and folds them in rank order, so every process
ends a step with bitwise-equal values and gradients.

Nothing tells a program of a cluster here, so ``init_distributed``
takes the coordinator's address, the process count and this process's
rank explicitly.  The backend follows the device: NCCL on CUDA, gloo on
the CPU.  NCCL refuses two ranks on one card, so on a one-card machine
a CUDA mesh runs at world size 1.

Typical use (one process a host)::

    from pinn_torch.parallel import distributed as dist
    dev = dist.init_distributed("host0:29500", num_processes=2,
                                process_id=rank)
    mesh = dist.make_multihost_mesh()          # (hosts, data)
    X_f = dist.shard_points_multihost(local_X_f, mesh)  # this rank's rows
    u = dist.replicate_multihost(u_train, mesh)         # same on every rank
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pinn_torch.device import DeviceLike, resolve_device
from pinn_torch.parallel.mesh import DATA_AXIS, Mesh, shard_points

HOST_AXIS = "hosts"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: Optional[str] = None,
                     device: DeviceLike = None,
                     timeout_s: float = 120.0) -> torch.device:
    """``torch.distributed.init_process_group`` at
    ``tcp://coordinator_address`` ("host:port").  ``device`` (default
    the card; ``"cpu"`` for the CPU) decides the backend, NCCL or gloo;
    a ``backend`` that disagrees raises.  A CUDA device without an
    index becomes ``cuda:<process_id mod card count>``, made current.
    Returns this process's device."""
    dev = resolve_device(device)
    want = BACKENDS[dev.type]
    if backend is not None and backend != want:
        raise ValueError(f"backend {backend!r} on a {dev.type} device: the "
                         f"port takes {want!r} there")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    dist.init_process_group(want, init_method=addr, world_size=num_processes,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _local_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_multihost_mesh(devices: Optional[Sequence[DeviceLike]] = None,
                        host_axis: str = HOST_AXIS,
                        data_axis: str = DATA_AXIS) -> Mesh:
    """(world size, local shards) mesh: the outer axis crosses
    processes, the inner one is ``devices`` (default: the one device
    ``init_distributed`` chose)."""
    devs = ([_local_device()] if devices is None
            else [resolve_device(d) for d in devices])
    return Mesh(devs, (host_axis, data_axis), n_hosts=dist.get_world_size(),
                group=dist.group.WORLD)


def shard_points_multihost(local_rows, mesh: Mesh) -> List[torch.Tensor]:
    """This process's rows split over its local shards (process p owns
    the global rows [p n, (p + 1) n)).  Every process must hold the same
    number of rows: pad with ``pad_points_with_weights`` otherwise."""
    rows = torch.as_tensor(np.asarray(local_rows))
    counts = [torch.zeros(1, dtype=torch.int64, device=mesh.devices[0])
              for _ in range(mesh.n_hosts)]
    dist.all_gather(counts, torch.tensor([rows.shape[0]],
                                         device=mesh.devices[0]),
                    group=mesh.group)
    if len({int(c) for c in counts}) != 1:
        raise ValueError(f"processes hold different row counts "
                         f"{[int(c) for c in counts]}")
    return shard_points(rows, mesh, mesh.axis_names[-1])


def replicate_multihost(arr, mesh: Mesh) -> torch.Tensor:
    """``arr`` (identical on every process) on this process's first
    device."""
    return torch.as_tensor(np.asarray(arr)).to(mesh.devices[0])
