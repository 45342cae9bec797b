"""The port's multi-process tier: two gloo processes on the CPU, each
with half of the collocation points (``pinn_torch.parallel.distributed``
and the fixed-order reduction of ``pinn_torch.parallel.dp``), against
oracles computed here: the port's single-process loss and JAX's on the
same inputs (tests/torch_dist_worker.py has the bars; it imports no
JAX).  Also world size 1 in this process, and ``pinn_torch.graft_entry``:
``entry()`` against ``__graft_entry__.entry()`` on the same weights and
batch, and ``dryrun_multichip(2, device="cpu")``.

NCCL refuses two ranks on one card, so the test of more than one rank
is this CPU one; the card runs world size 1 (chip_smoke.py phase 4t).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn.problems import burgers as jax_burgers
from pinn.utils import checkpoint as jax_checkpoint
from pinn_torch import graft_entry
from pinn_torch import params as pcodec
from pinn_torch.ops.fused_train import make_burgers_loss, make_burgers_loss_dp
from pinn_torch.parallel import data_parallel, make_mesh
from pinn_torch.parallel import distributed as pdist
from pinn_torch.problems import burgers
from pinn_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
NU = 0.01 / np.pi
LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)
LAYERS = [2, 8, 8, 1]

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.RandomState(1234)
    X_f = rng.uniform(LB, UB, size=(64, 2))
    X_u = rng.uniform(LB, UB, size=(16, 2))
    pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
             for a, b in zip(LAYERS[:-1], LAYERS[1:])]
    return pairs, {"X_u": X_u, "u": np.sin(np.pi * X_u[:, :1]), "X_f": X_f}


def _flat_value_and_grad(loss_fn, params, batch):
    leaves = [a.requires_grad_(True) for a in pcodec.leaves(params)]
    val = loss_fn(params, batch)
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), torch.cat([g.reshape(-1) for g in grads]).numpy()


def _torch(pairs, batch, dtype):
    return ([(torch.as_tensor(w, dtype=dtype), torch.as_tensor(b, dtype=dtype))
             for w, b in pairs],
            {k: torch.as_tensor(v, dtype=dtype) for k, v in batch.items()})


def _jax_value_and_grad(pairs, batch, dtype):
    lb, ub = jnp.asarray(LB, dtype), jnp.asarray(UB, dtype)

    def loss(p):
        return jax_burgers.loss_cont_inference(
            p, *(jnp.asarray(batch[k], dtype) for k in ("X_u", "u", "X_f")),
            lb, ub, NU)

    params = tuple((jnp.asarray(w, dtype), jnp.asarray(b, dtype))
                   for w, b in pairs)
    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(val), np.concatenate([np.ravel(a) for wb in grads for a in wb])


def test_two_process_dp_matches_oracles(tmp_path):
    pairs, batch = _inputs()
    lb64, ub64 = (torch.as_tensor(a, dtype=torch.float64) for a in (LB, UB))
    oracles = {}
    p64, b64 = _torch(pairs, batch, torch.float64)
    oracles["port64"] = _flat_value_and_grad(
        lambda p, b: burgers.loss_cont_inference(p, b["X_u"], b["u"],
                                                 b["X_f"], lb64, ub64, NU),
        p64, b64)
    oracles["jax64"] = _jax_value_and_grad(pairs, batch, jnp.float64)
    p32, b32 = _torch(pairs, batch, torch.float32)
    oracles["port_fused32"] = _flat_value_and_grad(
        make_burgers_loss(LB, UB, NU), p32, b32)
    oracles["jax32"] = _jax_value_and_grad(pairs, batch, jnp.float32)
    arrays = {f"{name}_{part}": v for name, (loss, grad) in oracles.items()
              for part, v in (("loss", loss), ("grad", grad))}
    for i, (w, b) in enumerate(pairs):
        arrays[f"w{i}"], arrays[f"b{i}"] = w, b
    path = str(tmp_path / "inputs.npz")
    np.savez(path, nu=NU, lb=LB, ub=UB, n_layers=len(pairs), **batch,
             **arrays)

    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(port), str(r), path],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DIST OK" in out, f"rank {r}:\n{out}"


def test_world_size_one_is_the_in_process_loss():
    """A (hosts, data) mesh of one process and one shard gives the
    in-process one-shard loss and Adam step bit for bit."""
    pairs, batch = _inputs()
    p32, b32 = _torch(pairs, batch, torch.float32)
    local = make_burgers_loss_dp(LB, UB, NU, make_mesh(devices=["cpu"]))
    want = graft_entry.adam_step(local, p32, b32)
    pdist.init_distributed(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        mesh = pdist.make_multihost_mesh()
        assert mesh.shape == {"hosts": 1, "data": 1}
        got = graft_entry.adam_step(make_burgers_loss_dp(LB, UB, NU, mesh),
                                    p32, b32)
    finally:
        torch.distributed.destroy_process_group()
    assert got[0] == want[0] and torch.equal(got[1], want[1])
    assert torch.equal(pcodec.ravel(got[2]), pcodec.ravel(want[2]))


def test_entry_matches_jax_graft_entry(tmp_path):
    """The flagship loss at the default shapes on JAX's weights (through
    an npz) and batch: float32 to rtol 1e-5, float64 to rtol 1e-10."""
    import __graft_entry__
    jfn, (jparams, jbatch) = __graft_entry__.entry()
    fn, (params, batch) = graft_entry.entry(device="cpu")
    assert [tuple(a.shape) for a in pcodec.leaves(params)] == \
        [a.shape for wb in jparams for a in wb]
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: v.shape for k, v in jbatch.items()}
    path = str(tmp_path / "entry.npz")
    jax_checkpoint.save_npz(path, jparams)
    params, _ = checkpoint.load_npz(path, like=params)
    tb = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    np.testing.assert_allclose(float(fn(params, tb)),
                               float(jax.jit(jfn)(jparams, jbatch)), rtol=1e-5)

    to64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  (jparams, jbatch))
    p64 = pcodec.tree_map(lambda a: a.double(), params)
    tb64 = {k: v.double() for k, v in tb.items()}
    np.testing.assert_allclose(float(fn(p64, tb64)),
                               float(jax.jit(jfn)(*to64)), rtol=1e-10)


def test_dryrun_multichip_cpu(capsys):
    graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "eager DP (2 shards) train step OK" in out
    assert "fused DP (2 shards) train step OK" in out
    assert out.count("MULTIHOST OK") == 2


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
