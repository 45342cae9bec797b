"""Shared experiment scaffolding of the port: hp checks, seeding, dtype
and device resolution, the per-case checkpoint paths, and the residual
the experiments score points with.

Counterpart of ``experiments/_common.py``.  The identification
experiments train a clean and a noisy case inside one ``run``; each
case warm-starts from, and saves to, its own checkpoint
(``<path>-noisy.npz`` for the noisy one).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from pinn_torch.device import resolve_device
from pinn_torch.utils import checkpoint
from pinn_torch.utils.config import load_hp, validate_hp


def resolve_dtype(hp) -> torch.dtype:
    """hp["dtype"] in {"float32", "float64", "bfloat16"}, default
    "float32".  "bfloat16" runs the whole experiment in bf16 where the
    JAX one does: the init, the data, the bounds and the L-BFGS
    iterate (unless ``nt_vector_dtype`` widens it).  ``net_impl:
    "df32"`` (the JAX package's double-f32 engine) runs as native
    float64 and requires "float64"."""
    name = hp.get("dtype", "float32")
    if name not in ("float32", "float64", "bfloat16"):
        raise ValueError(f"dtype {name!r}: the experiments run in float32, "
                         "float64 or bfloat16")
    if hp.get("net_impl") == "df32" and name != "float64":
        raise ValueError("net_impl='df32' requires dtype=float64 "
                         "(on this port it runs as native float64)")
    return getattr(torch, name)


def wants_bf16(value) -> bool:
    """Whether an hp value (``fused_residual``, ``tf_net_dtype``) names
    bf16, as the JAX experiments read it."""
    return str(value).lower() in ("bf16", "bfloat16")


def setup(hp) -> Tuple[int, torch.dtype, torch.device]:
    """Validate ``hp``, seed numpy (the data draws' RNG stream, as in the
    JAX run) and resolve dtype and device.  Returns ``(seed, dtype,
    device)``."""
    validate_hp(hp)
    seed = hp.get("seed", 1234)
    np.random.seed(seed)
    dtype = resolve_dtype(hp)
    device = resolve_device(hp.get("device"))
    # Full-precision float32 products: second-derivative residuals do
    # not survive TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    return seed, dtype, device


def command_line(argv, defaults) -> Tuple[dict, bool]:
    """An experiment's ``[hp.json] [--plot]``: its hp (``defaults``
    updated by the file) and whether to draw.  The JAX scripts always
    draw; here the figure is asked for, because drawing needs
    matplotlib."""
    return (load_hp([a for a in argv if a != "--plot"], defaults),
            "--plot" in argv)


def resolve_mesh(hp, device: torch.device):
    """hp["tpu_mesh"] as a ``pinn_torch.parallel`` mesh, or None when
    absent.  On the card ``true`` takes every visible CUDA device (one
    shard on a one-card machine) and an int that many, raising when
    fewer are visible; with ``device: "cpu"`` an int is that many CPU
    shards and ``true`` one."""
    req = hp.get("tpu_mesh")
    if not req:
        return None
    from pinn_torch.parallel import make_mesh
    n = None if req is True else int(req)
    if device.type == "cpu":
        return make_mesh(devices=[device] * (n or 1))
    return make_mesh(n)


def check_no_mesh(hp) -> None:
    """The experiments on small point sets refuse ``tpu_mesh``, as the
    JAX ones do: a few hundred points do not pay for sharding."""
    if hp.get("tpu_mesh"):
        raise ValueError("tpu_mesh is not supported by this experiment "
                         "(tiny point sets; see PARITY.md S2.5)")


def _case_path(path: str, case) -> str:
    """``path`` suffixed per sub-case (``run-noisy.npz``)."""
    if not case:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}-{case}{ext or '.npz'}"


def maybe_load_params(hp, params, case=None):
    """hp["init_checkpoint"]: warm-start from a saved flat-vector npz,
    in ``params``' structure, dtypes and devices."""
    path = hp.get("init_checkpoint")
    if path:
        path = _case_path(path, case)
        params, _ = checkpoint.load_npz(path, like=params)
        print(f"Loaded initial parameters from {path}")
    return params


def residual_fn(lb, ub, nu: float, dtype: torch.dtype):
    """``f(params, X) -> (N, 1)``, the Burgers residual without
    gradients, as the experiments score points (RAR's candidate pool,
    ``f_pred``, the serving example's members).  float32: the
    residual-evaluation kernel (``pinn_torch.ops.residual
    .burgers_residual``; its plain version on the CPU).  float64: the
    eager ``residual_cont``, because the kernel is float32 only and a
    float64 stage scored in float32 would rank its points differently.
    """
    from pinn_torch.problems import burgers

    if dtype == torch.float32:
        from pinn_torch.ops.residual import _box, burgers_residual
        box = _box(lb, ub)   # host copies, read once

        def f(params, X):
            return burgers_residual(params, X, *box, nu)
    else:
        @torch.no_grad()
        def f(params, X):
            return burgers.residual_cont(params, X, lb, ub, nu=nu)
    return f


def maybe_save_params(hp, params, case=None) -> None:
    """hp["save_checkpoint"]: persist the trained parameters."""
    path = hp.get("save_checkpoint")
    if path:
        path = checkpoint.save_npz_atomic(_case_path(path, case), params,
                                          hp=hp)
        print(f"Saved checkpoint to {path}")
