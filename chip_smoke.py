#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pinn_torch``) once on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Card: the name and power limit as nvidia-smi reports them.
2. Build: compile ``pinn_torch/csrc/*.cu`` with nvcc for sm_90a.
3. Kernel vs plain: each CUDA kernel of the Burgers training path
   against its plain PyTorch version on the card, at the flagship
   [2, 20x8, 1] (N = 10,100), the width-40 [2, 40x8, 1] and a ragged
   [2, 16, 1]; bitwise repeatability; median times at the flagship.
4. Main path: ``pinn_torch.experiments.inf_cont_burgers.run`` twice at
   the flagship width — a fused float32 stage (Adam, then mixed-precision
   L-BFGS with a Wolfe search and resampling) and a float64 refinement
   stage from its checkpoint.  Both kernels must have been launched by
   stage 1, its loss must fall, and every number must be finite.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

NU = 0.01 / np.pi
LB = np.array([-1.0, 0.0], np.float32)
UB = np.array([1.0, 1.0], np.float32)
FLAGSHIP = [2] + [20] * 8 + [1]
WIDE = [2] + [40] * 8 + [1]
KERNEL_SHAPES = [           # (layers, N_u, N_f)
    (FLAGSHIP, 100, 10000),
    (WIDE, 100, 1024),
    ([2, 16, 1], 7, 1017),  # ragged edge inside a 32-point tile
]
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
SOURCE = "pinn_torch/csrc/burgers_train.cu"
REPLACES = {"burgers_loss_grad": "pinn/ops/pallas_train.py:524",
            "burgers_loss": "pinn/ops/pallas_train.py:576"}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[card] nvidia-smi: {smi}")
    log(f"[card] torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"device: {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
    from pinn_torch.ops import _build
    lib = _build.library()
    log(f"[build] {lib.path.name}: {lib.build_seconds:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


def _kernel_inputs(layers, n_u, n_f, seed):
    """Seeded numpy weights and points, prepared for the kernels on the card."""
    import torch
    from pinn_torch.ops import fused_train
    from pinn_torch.utils.checkpoint import params_from_numpy

    rng = np.random.RandomState(seed)
    pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
             for a, b in zip(layers[:-1], layers[1:])]
    params = params_from_numpy(pairs, "cuda", torch.float32)
    batch = {"X_u": LB + (UB - LB) * rng.rand(n_u, 2),
             "u": rng.rand(n_u, 1),
             "X_f": LB + (UB - LB) * rng.rand(n_f, 2)}
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
             for k, v in batch.items()}
    lb, ub = (torch.as_tensor(a, device="cuda") for a in (LB, UB))
    a0, aux = fused_train._prep_points(batch, lb, ub)
    scale = 2.0 / (ub - lb)
    zero = torch.zeros((), device="cuda")
    vx, vt = torch.stack([scale[0], zero]), torch.stack([zero, scale[1]])
    z1row, z2row, wt_args = fused_train._prep(params, vx, vt)
    return a0, aux, z1row, z2row, wt_args


def _flat(out):
    loss, gwt, gz1, gz2 = out
    return loss.reshape(1), [g.reshape(-1) for g in (*gwt, gz1, gz2)]


def _median_ms(fn, reps=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns per-kernel stats."""
    import torch
    from pinn_torch.ops import fused_train as ft

    stats = {"burgers_loss_grad": {"max_abs_err": 0.0},
             "burgers_loss": {"max_abs_err": 0.0}}
    for i, (layers, n_u, n_f) in enumerate(KERNEL_SHAPES):
        args = _kernel_inputs(layers, n_u, n_f, seed=100 + i)
        got = ft.burgers_loss_grad(*args, NU)
        again = ft.burgers_loss_grad(*args, NU)
        loss_only = ft.burgers_loss(*args, NU)
        want = ft.burgers_loss_grad_plain(*args, NU)
        want_loss = ft.burgers_loss_plain(*args, NU)
        torch.cuda.synchronize()

        g_loss, g_grads = _flat(got)
        a_loss, a_grads = _flat(again)
        w_loss, w_grads = _flat(want)
        tag = f"{layers[1]}x{len(layers) - 2} N={n_u + n_f}"
        torch.testing.assert_close(g_loss, w_loss, rtol=1e-5, atol=0.0)
        gmax = max(float(w.abs().max()) for w in w_grads)
        err = float(abs(g_loss - w_loss).max())
        for g, w in zip(g_grads, w_grads):
            torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-6 * gmax)
            err = max(err, float((g - w).abs().max()))
        torch.testing.assert_close(loss_only.reshape(1), g_loss, rtol=1e-6,
                                   atol=0.0)
        torch.testing.assert_close(loss_only, want_loss, rtol=1e-5, atol=0.0)
        if not (torch.equal(g_loss, a_loss)
                and all(torch.equal(g, a) for g, a in zip(g_grads, a_grads))):
            raise AssertionError(f"{tag}: two launches differ bitwise")
        lerr = float(abs(loss_only - want_loss))
        stats["burgers_loss_grad"]["max_abs_err"] = max(
            stats["burgers_loss_grad"]["max_abs_err"], err)
        stats["burgers_loss"]["max_abs_err"] = max(
            stats["burgers_loss"]["max_abs_err"], lerr)
        log(f"[kernels] {tag}: loss {float(g_loss):.6e} (plain "
            f"{float(w_loss):.6e}), grad max|err| {err:.3e} of max|g| "
            f"{gmax:.3e}, loss-only |err| {lerr:.3e}, bitwise repeatable")

        if i == 0:  # times at the flagship shape
            t = {"burgers_loss_grad": _median_ms(lambda: ft.burgers_loss_grad(*args, NU)),
                 "plain_loss_grad": _median_ms(lambda: ft.burgers_loss_grad_plain(*args, NU)),
                 "burgers_loss": _median_ms(lambda: ft.burgers_loss(*args, NU)),
                 "plain_loss": _median_ms(lambda: ft.burgers_loss_plain(*args, NU))}
            stats["burgers_loss_grad"].update(ms=t["burgers_loss_grad"],
                                              plain_ms=t["plain_loss_grad"])
            stats["burgers_loss"].update(ms=t["burgers_loss"],
                                         plain_ms=t["plain_loss"])
            log(f"[kernels] {tag} median ms: loss+grad kernel "
                f"{t['burgers_loss_grad']:.4f} vs plain {t['plain_loss_grad']:.4f}; "
                f"loss kernel {t['burgers_loss']:.4f} vs plain {t['plain_loss']:.4f}")
    return stats


def _logged_losses(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    return [(r["phase"], r["epoch"], r["loss"]) for r in recs
            if r.get("event") == "epoch"]


def phase_main_path() -> dict:
    """Two stages of the flagship recipe through the user entry point."""
    import torch
    from pinn_torch.experiments import inf_cont_burgers
    from pinn_torch.ops import fused_train as ft

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    ckpt = os.path.join(WORK_DIR, "stage1.npz")
    stage1 = {"device": "cuda", "layers": FLAGSHIP, "N_u": 100,
              "N_f": 10000, "fused_residual": True,
              "nt_vector_dtype": "float64", "nt_line_search": "wolfe",
              "tf_epochs": 200, "nt_epochs": 200, "nt_resample": 100,
              "log_frequency": 50, "save_checkpoint": ckpt,
              "log_file": os.path.join(WORK_DIR, "stage1.jsonl")}
    stage2 = {"device": "cuda", "layers": FLAGSHIP, "N_u": 100,
              "N_f": 10000, "dtype": "float64", "net_impl": "df32",
              "init_checkpoint": ckpt, "tf_epochs": 0, "nt_epochs": 50,
              "nt_line_search": "wolfe", "nt_resample": 25,
              "nt_val_every": 25, "log_frequency": 25,
              "log_file": os.path.join(WORK_DIR, "stage2.jsonl")}

    ft.n_launch_loss_grad = 0
    ft.n_launch_loss = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r1 = inf_cont_burgers.run(stage1)
    torch.cuda.synchronize()
    s1_seconds = time.perf_counter() - t0
    launches = {"burgers_loss_grad": ft.n_launch_loss_grad,
                "burgers_loss": ft.n_launch_loss}
    log(f"[main] stage 1 launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"stage 1 never launched {name}")

    losses1 = _logged_losses(stage1["log_file"])
    first, last = losses1[0][2], losses1[-1][2]
    log(f"[main] stage 1 logged losses: " + ", ".join(
        f"{p}={e}:{l:.4e}" for p, e, l in losses1))
    if not last < first:
        raise AssertionError(f"stage 1 loss did not fall: {first} -> {last}")
    timing = r1["timing"]
    adam_rate = stage1["tf_epochs"] / timing["adam_s"]
    lbfgs_rate = timing["lbfgs_iters"] / timing["lbfgs_s"]
    log(f"[main] stage 1: rel-L2 {r1['error']:.6e}, {s1_seconds:.2f} s, "
        f"Adam {adam_rate:.2f} steps/s, L-BFGS {lbfgs_rate:.2f} iters/s "
        f"({timing['lbfgs_iters']} iterations)")

    t0 = time.perf_counter()
    r2 = inf_cont_burgers.run(stage2)
    torch.cuda.synchronize()
    s2_seconds = time.perf_counter() - t0
    losses2 = _logged_losses(stage2["log_file"])
    log(f"[main] stage 2 (float64): rel-L2 {r2['error']:.6e}, "
        f"{s2_seconds:.2f} s, logged losses: " + ", ".join(
            f"{p}={e}:{l:.4e}" for p, e, l in losses2))

    values = [r1["error"], r2["error"], adam_rate, lbfgs_rate,
              *[l for _, _, l in losses1 + losses2]]
    for r in (r1, r2):
        values += [float(np.max(np.abs(r["u_pred"]))),
                   float(np.max(np.abs(r["f_pred"])))]
        for w, b in r["params"]:
            values += [float(w.abs().max()), float(b.abs().max())]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite value in the results: {values}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_card()
    phase_build()
    stats = phase_kernels()
    launches = phase_main_path()
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                **stats[name]} for name in ("burgers_loss_grad", "burgers_loss")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
