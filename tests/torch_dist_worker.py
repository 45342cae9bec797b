"""One process of the two-process test of ``pinn_torch.parallel``
(tests/test_torch_distributed.py); imports no JAX.  Run as:

    python tests/torch_dist_worker.py <port> <rank> <inputs.npz>

Joins a 2-process gloo group on the CPU, builds a (hosts, data) mesh of
2 x 2 shards, takes this rank's half of the collocation points, and
checks the data-parallel loss and gradients, eager (float64) and fused
(float32, the kernel's plain version), against the oracles the parent
wrote to the npz: the port's single-process loss and JAX's.  Then one
Adam step of each loss, whose parameters must be bitwise equal on both
ranks.  Prints ``DIST OK`` on success.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from pinn_torch import params as pcodec  # noqa: E402
from pinn_torch.graft_entry import adam_step  # noqa: E402
from pinn_torch.ops.fused_train import make_burgers_loss_dp  # noqa: E402
from pinn_torch.parallel import data_parallel  # noqa: E402
from pinn_torch.parallel import distributed as pdist  # noqa: E402
from pinn_torch.problems import burgers  # noqa: E402

port, rank, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
z = np.load(path)
nu = float(z["nu"])
lb, ub = z["lb"], z["ub"]
n_layers = int(z["n_layers"])

dev = pdist.init_distributed(f"localhost:{port}", 2, rank, device="cpu")
mesh = pdist.make_multihost_mesh(devices=[dev] * 2)
assert mesh.shape == {"hosts": 2, "data": 2} and mesh.size == 4, mesh


def inputs(dtype):
    params = [(torch.as_tensor(z[f"w{i}"], dtype=dtype),
               torch.as_tensor(z[f"b{i}"], dtype=dtype))
              for i in range(n_layers)]
    half = z["X_f"].shape[0] // 2
    batch = {"X_u": pdist.replicate_multihost(z["X_u"], mesh).to(dtype),
             "u": pdist.replicate_multihost(z["u"], mesh).to(dtype),
             "X_f": torch.as_tensor(z["X_f"][rank * half:(rank + 1) * half],
                                    dtype=dtype)}
    return params, batch


def value_and_grad(loss_fn, params, batch):
    leaves = [a.clone().requires_grad_(True) for a in pcodec.leaves(params)]
    val = loss_fn(pcodec.rebuild(params, leaves), batch)
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), torch.cat([g.reshape(-1) for g in grads]).numpy()


def check(tag, got, oracle, rtol, grtol, gatol):
    val, grad = got
    np.testing.assert_allclose(val, float(z[oracle + "_loss"]), rtol=rtol,
                               err_msg=f"{tag} vs {oracle}")
    np.testing.assert_allclose(grad, z[oracle + "_grad"], rtol=grtol,
                               atol=gatol, err_msg=f"{tag} vs {oracle}")


shards = pdist.shard_points_multihost(z["X_f"][:z["X_f"].shape[0] // 2], mesh)
assert [s.shape[0] for s in shards] == [z["X_f"].shape[0] // 4] * 2

# Eager, float64: the bars of tests/helpers_dist_worker.py.
lb64, ub64 = (torch.as_tensor(a, dtype=torch.float64) for a in (lb, ub))


def eager(p, b):
    return burgers.loss_cont_inference(p, b["X_u"], b["u"], b["X_f"],
                                       lb64, ub64, nu)


eager_dp = data_parallel(eager, mesh, ("X_f",))
params64, batch64 = inputs(torch.float64)
got = value_and_grad(eager_dp, params64, batch64)
for oracle in ("port64", "jax64"):
    check("eager DP", got, oracle, 1e-6, 1e-5, 1e-7)

# Fused, float32 (the kernel's plain version): against the port's
# single-process fused loss at the same bars, against JAX's eager
# float32 loss at the kernel bars.
fused_dp = make_burgers_loss_dp(lb, ub, nu, mesh)
params32, batch32 = inputs(torch.float32)
got = value_and_grad(fused_dp, params32, batch32)
check("fused DP", got, "port_fused32", 1e-6, 1e-5, 1e-7)
check("fused DP", got, "jax32", 1e-5, 5e-4,
      5e-6 * float(np.abs(z["jax32_grad"]).max()))

# One Adam step of each: bitwise-equal parameters on both ranks.
flat = torch.cat([pcodec.ravel(adam_step(eager_dp, params64, batch64)[2]),
                  pcodec.ravel(adam_step(fused_dp, params32,
                                         batch32)[2]).double()])
both = [torch.empty_like(flat) for _ in range(2)]
dist.all_gather(both, flat)
assert torch.equal(both[0], both[1]), "ranks differ after one Adam step"
dist.destroy_process_group()
print(f"DIST OK rank={rank} loss={got[0]:.6e}", flush=True)
