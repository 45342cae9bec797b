"""Driver entry points of the port: the flagship loss, and a dry run of
one training step on every data-parallel placement.

Counterpart of the repository's ``__graft_entry__.py``.

``entry(device=None)`` returns the flagship loss — the continuous
Burgers PINN loss (network forward + Taylor-mode residual derivatives)
at the reference's default shapes, [2, 20x8, 1], N_u = 100,
N_f = 10,000, float32 — with example arguments, on the card unless
``device`` names another.

``dryrun_multichip(n, device=None)`` runs one full Adam step on every
placement, each against the unsharded step:

1. the eager loss on an n-shard mesh (``X_u``, ``u`` and ``X_f`` cut
   over the shards, ``pinn_torch.parallel.data_parallel``);
2. the fused loss on the same mesh (``make_burgers_loss_dp``: one
   kernel launch a shard);
3. two processes on the CPU (gloo), each with its half of the points
   over ``max(1, n // 2)`` local shards of a (hosts, data) mesh
   (``pinn_torch.parallel.distributed``), eager and fused; both ranks
   must end the step with bitwise-equal parameters;
4. when n is even, the eager loss on an (n/2, 2) (data, model) mesh:
   the points cut over the data rows, the parameters placed by
   ``shard_params_tp`` over the model axis (``pinn_torch.parallel.tp``).

The meshes of legs 1, 2 and 4 are the first n cards when that many are
visible; otherwise n shards on one device (``device``, or the CPU's).

Run by hand: ``python -m pinn_torch.graft_entry [N] [--device cpu]``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from pinn_torch import params as pcodec
from pinn_torch.device import DeviceLike, resolve_device
from pinn_torch.models import mlp
from pinn_torch.problems import burgers

FLAGSHIP = [2, 20, 20, 20, 20, 20, 20, 20, 20, 1]
NU = 0.01 / np.pi
LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _eager_loss(dev: torch.device):
    lb = torch.as_tensor(LB, device=dev)
    ub = torch.as_tensor(UB, device=dev)

    def fn(params, batch):
        return burgers.loss_cont_inference(params, batch["X_u"], batch["u"],
                                           batch["X_f"], lb, ub, NU)
    return fn


def entry(device: DeviceLike = None):
    """``(fn, (params, batch))``: the flagship loss ``fn(params, batch)``
    and seeded example arguments on ``device`` (default: the card)."""
    dev = resolve_device(device)
    params = mlp.init_mlp(FLAGSHIP, torch.Generator().manual_seed(1234),
                          torch.float32, dev)
    g = torch.Generator().manual_seed(0)
    batch = {"X_u": torch.rand((100, 2), generator=g),
             "u": torch.rand((100, 1), generator=g),
             "X_f": torch.rand((10000, 2), generator=g)}
    return _eager_loss(dev), (params, {k: v.to(dev) for k, v in batch.items()})


def _inputs(n_u: int, n_f: int, dev: torch.device):
    """Small seeded inputs, the same on every process."""
    rng = np.random.RandomState(1234)
    X_f = rng.uniform(LB, UB, size=(n_f, 2))
    X_u = rng.uniform(LB, UB, size=(n_u, 2))
    batch = {"X_u": X_u, "u": np.sin(np.pi * X_u[:, :1]), "X_f": X_f}
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in batch.items()}
    params = mlp.init_mlp([2, 16, 16, 1], torch.Generator().manual_seed(0),
                          torch.float32, dev)
    return params, batch


def adam_step(loss_fn, params, batch, lr: float = 1e-3):
    """One Adam step of ``loss_fn`` from ``params``: (loss, flat
    gradient, new params)."""
    leaves = [a.detach().clone().requires_grad_(True)
              for a in pcodec.leaves(params)]
    opt = torch.optim.Adam(leaves, lr=lr)
    loss = loss_fn(pcodec.rebuild(params, leaves), batch)
    loss.backward()
    grad = torch.cat([a.grad.reshape(-1) for a in leaves])
    opt.step()
    return (float(loss.detach()), grad,
            pcodec.rebuild(params, [a.detach() for a in leaves]))


def _check_step(tag, got, want):
    """A DP step against the unsharded one: the loss to rtol 1e-6, the
    gradients to rtol 2e-5, atol 1e-7 (the JAX package's sharded-loss
    bars); the new parameters finite."""
    (loss, grad, params), (loss0, grad0, _) = got, want
    if not all(torch.isfinite(a).all() for a in pcodec.leaves(params)):
        raise RuntimeError(f"{tag}: non-finite parameters after the step")
    np.testing.assert_allclose(loss, loss0, rtol=1e-6, err_msg=tag)
    np.testing.assert_allclose(grad.cpu().numpy(), grad0.cpu().numpy(),
                               rtol=2e-5, atol=1e-7, err_msg=tag)
    print(f"dryrun_multichip: {tag} train step OK, loss = {loss:.6f}",
          flush=True)


def _legs(mesh, dev, n_u: int, n_f: int, process: str = ""):
    """The eager and fused DP steps on ``mesh`` against the unsharded
    ones; returns both steps' parameters."""
    from pinn_torch.ops.fused_train import make_burgers_loss, make_burgers_loss_dp
    from pinn_torch.parallel import data_parallel

    params, batch = _inputs(n_u, n_f, dev)
    eager = _eager_loss(dev)
    fused = make_burgers_loss(LB, UB, NU)
    if mesh.group is not None:   # this process's half of the points
        rank, half = torch.distributed.get_rank(), n_f // 2
        local = {**batch, "X_f": batch["X_f"][rank * half:(rank + 1) * half]}
        n_u_local = n_u // mesh.n_hosts
        local["X_u"] = batch["X_u"][rank * n_u_local:(rank + 1) * n_u_local]
        local["u"] = batch["u"][rank * n_u_local:(rank + 1) * n_u_local]
    else:
        local = batch
    shards = f"{mesh.size} shards{process}"
    e = adam_step(data_parallel(eager, mesh, ("X_u", "u", "X_f")), params,
                  local)
    _check_step(f"eager DP ({shards})", e, adam_step(eager, params, batch))
    fused_local = {**local, "X_u": batch["X_u"], "u": batch["u"]}
    f = adam_step(make_burgers_loss_dp(LB, UB, NU, mesh), params, fused_local)
    _check_step(f"fused DP ({shards})", f, adam_step(fused, params, batch))
    return e[2], f[2]


def _worker(port: int, rank: int, n_local: int) -> None:
    """One process of the two-process leg (CPU, gloo)."""
    import torch.distributed as dist
    from pinn_torch.parallel import distributed as pdist

    torch.set_num_threads(1)
    dev = pdist.init_distributed(f"localhost:{port}", 2, rank, device="cpu")
    try:
        mesh = pdist.make_multihost_mesh(devices=[dev] * n_local)
        stepped = _legs(mesh, dev, 4 * n_local, 16 * n_local,
                        f", 2 processes, rank {rank}")
        flat = torch.cat([pcodec.ravel(p) for p in stepped])
        both = [torch.empty_like(flat) for _ in range(2)]
        dist.all_gather(both, flat)
        if not torch.equal(both[0], both[1]):
            raise RuntimeError("the two ranks' parameters differ after a step")
        print(f"MULTIHOST OK rank={rank}", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multihost(n_local: int = 1, timeout: float = 120.0) -> None:
    """Leg 3: two gloo processes on the CPU, ``n_local`` shards each;
    both are killed if either outlives ``timeout`` seconds."""
    port = _free_port()
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
                   os.pathsep) if p])}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pinn_torch.graft_entry", "--worker",
         str(port), str(rank), str(n_local)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        sys.stdout.write(out)
        if p.returncode != 0 or "MULTIHOST OK" not in out:
            raise RuntimeError(f"two-process dry run failed "
                               f"(rc={p.returncode}):\n{err[-3000:]}")
    print(f"dryrun_multichip: 2 processes x {n_local} shards (gloo) OK",
          flush=True)


def _tp_leg(n_devices: int, dev: torch.device) -> None:
    """Leg 4: one Adam step of the eager loss on tensor-parallel
    parameters and sharded points, on an (n/2, 2) mesh."""
    from pinn_torch.parallel import (data_parallel, make_mesh_2d,
                                     shard_params_tp)

    n_data = n_devices // 2
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        mesh = make_mesh_2d(n_data, 2)
    else:
        mesh = make_mesh_2d(n_data, 2, devices=[dev] * n_devices)
    home = mesh.devices[0]
    params, batch = _inputs(2 * n_devices, 4 * n_devices, home)
    eager = _eager_loss(home)
    got = adam_step(data_parallel(eager, mesh, ("X_u", "u", "X_f")),
                    shard_params_tp(params, mesh), batch)
    _check_step(f"TP+DP ({n_data}x2 mesh)", got,
                adam_step(eager, params, batch))


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """Legs 1-4 of the module's docstring; raises on any failure."""
    from pinn_torch.parallel import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        mesh = make_mesh(n_devices)
        dev = mesh.devices[0]
    else:
        mesh = make_mesh(devices=[dev] * n_devices)
    print(f"dryrun_multichip({n_devices}): {mesh}", flush=True)
    _legs(mesh, dev, 2 * n_devices, 4 * n_devices)
    if n_devices % 2 == 0:
        _tp_leg(n_devices, dev)
    dryrun_multihost(n_local=max(1, n_devices // 2))


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        _worker(*map(int, argv[1:4]))
        return 0
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    dryrun_multichip(int(argv[0]) if argv else 8, device)
    fn, (params, batch) = entry(device)
    print(f"entry loss: {float(fn(params, batch)):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
