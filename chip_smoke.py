#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pinn_torch``) once on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Card: the name and power limit as nvidia-smi reports them.
2. Build: compile ``pinn_torch/csrc/*.cu`` with nvcc for sm_90a (one
   process per source, side by side) and print ptxas's register,
   shared-memory and spill lines.
3. Burgers inference kernels vs plain: each against its plain PyTorch
   version on the card, at the flagship [2, 20x8, 1] (N = 10,100), the
   width-40 [2, 40x8, 1] and a ragged [2, 16, 1]; bitwise
   repeatability; median times at the flagship.
3b. Burgers identification kernels vs plain, at [2, 20x8, 1] (N =
   2,000), [2, 20, 20, 20, 1] (N = 300) and [2, 16, 1] (N = 1,017), for
   (lambda1, log lambda2) = (0, -6) and (1.3, -4); times at N = 2,000.
3c. Schrödinger kernels vs plain, at [2, 100x4, 2] (N = 20,000 and
   300) and [2, 32, 2] (N = 512); times at N = 20,000.
4. Burgers inference main path: ``pinn_torch.experiments
   .inf_cont_burgers.run`` twice at the flagship width, a fused float32
   stage (Adam, then mixed-precision L-BFGS with a Wolfe search and
   resampling) and a float64 refinement stage from its checkpoint.
4b. Identification main path: ``ide_cont_burgers.run`` (clean and 1 %
   noise cases) at [2, 20x8, 1], N_u = 2,000, a fused stage and a
   float64 stage from its per-case checkpoints.
4c. Schrödinger main path: ``inf_cont_schrodinger.run`` at [2, 100x4,
   2], N_f = 20,000, a fused stage and a float64 stage from its
   checkpoint.
Each main path runs with every launch count set to 0 just before its
fused stage; every kernel of the path must have launched by its end,
the logged loss must fall and every reported number must be finite.

The last three lines are the nvidia-smi line, a JSON object describing
each kernel, and ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits with code 2 and prints no result.
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
S_LB = np.array([-5.0, 0.0], np.float32)        # Schrödinger domain
S_UB = np.array([5.0, np.pi / 2], np.float32)
FLAGSHIP = [2] + [20] * 8 + [1]
WIDE = [2] + [40] * 8 + [1]
S_FLAGSHIP = [2, 100, 100, 100, 100, 2]
KERNEL_SHAPES = [           # (layers, N_u, N_f)
    (FLAGSHIP, 100, 10000),
    (WIDE, 100, 1024),
    ([2, 16, 1], 7, 1017),  # ragged edge inside a 32-point tile
]
IDE_SHAPES = [(FLAGSHIP, 2000), ([2, 20, 20, 20, 1], 300), ([2, 16, 1], 1017)]
IDE_LAMBDAS = [(0.0, -6.0), (1.3, -4.0)]
SCHRODINGER_SHAPES = [(S_FLAGSHIP, 20000), (S_FLAGSHIP, 300), ([2, 32, 2], 512)]
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
BURGERS_SRC = "pinn_torch/csrc/burgers_train.cu"
SCHRODINGER_SRC = "pinn_torch/csrc/schrodinger_train.cu"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "burgers_loss_grad": (BURGERS_SRC, "pinn/ops/pallas_train.py:524"),
    "burgers_loss": (BURGERS_SRC, "pinn/ops/pallas_train.py:576"),
    "burgers_ide_loss_grad": (BURGERS_SRC, "pinn/ops/pallas_train.py:847"),
    "burgers_ide_loss": (BURGERS_SRC, "pinn/ops/pallas_train.py:906"),
    "schrodinger_sse_grad": (SCHRODINGER_SRC,
                             "pinn/ops/pallas_schrodinger.py:95"),
    "schrodinger_sse": (SCHRODINGER_SRC, "pinn/ops/pallas_schrodinger.py:70"),
}


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
        if "registers" in line or "spill" in line or "smem" in line \
                or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def _weights(layers, rng):
    from pinn_torch.utils.checkpoint import params_from_numpy
    import torch
    pairs = [(rng.randn(a, b) * np.sqrt(2.0 / (a + b)), 0.1 * rng.randn(b))
             for a, b in zip(layers[:-1], layers[1:])]
    return params_from_numpy(pairs, "cuda", torch.float32)


def _kernel_inputs(layers, n_u, n_f, seed):
    """Seeded numpy weights and points, prepared for the inference
    kernels on the card."""
    import torch
    from pinn_torch.ops import fused_train as ft

    rng = np.random.RandomState(seed)
    params = _weights(layers, rng)
    batch = {"X_u": LB + (UB - LB) * rng.rand(n_u, 2),
             "u": rng.rand(n_u, 1),
             "X_f": LB + (UB - LB) * rng.rand(n_f, 2)}
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
             for k, v in batch.items()}
    lb, ub, vx, vt = ft._tangents(LB, UB, "cuda")
    a0, aux = ft._prep_points(batch, lb, ub)
    return (a0, aux, *ft._prep(params, vx, vt))


def _ide_inputs(layers, n, lam, seed):
    import torch
    from pinn_torch.ops import fused_train as ft

    rng = np.random.RandomState(seed)
    params = _weights(layers, rng)
    batch = {"X_u": LB + (UB - LB) * rng.rand(n, 2), "u": rng.rand(n, 1)}
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device="cuda")
             for k, v in batch.items()}
    lb, ub, vx, vt = ft._tangents(LB, UB, "cuda")
    a0, aux = ft._prep_ide_points(batch, lb, ub)
    lam_t = ft._lam(torch.tensor([lam[0]], device="cuda"),
                    torch.tensor([lam[1]], device="cuda"))
    return (a0, aux, lam_t, *ft._prep(params, vx, vt))


def _schrodinger_inputs(layers, n, seed):
    import torch
    from pinn_torch.ops import fused_train as ft

    rng = np.random.RandomState(seed)
    params = _weights(layers, rng)
    X_f = torch.as_tensor(S_LB + (S_UB - S_LB) * rng.rand(n, 2),
                          dtype=torch.float32, device="cuda")
    lb, ub, vx, vt = ft._tangents(S_LB, S_UB, "cuda")
    return (ft._normalise(X_f, lb, ub), *ft._prep(params, vx, vt))


def _flat(out):
    """[loss, *grads] of a loss+grad output, every piece 1-D; an extra
    fifth element (the identification lambda adjoints) goes last."""
    loss, gwt, gz1, gz2, *extra = out
    return [loss.reshape(1)] + [g.reshape(-1) for g in (*gwt, gz1, gz2, *extra)]


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


def _check_pair(stats, tag, grad_name, loss_name, kernel_grad, kernel_loss,
                plain_grad, plain_loss, args, n_lam=0, time_it=False):
    """Hold the loss+grad and loss-only kernels to their plain versions
    on ``args``: loss rtol 1e-5; net gradients rtol 5e-4 with atol
    5e-6 * max|g|; the last ``n_lam`` gradient pieces (the lambda
    adjoints) rtol 1e-4; the loss-only kernel to the loss+grad one at
    rtol 1e-6; two launches bitwise equal.  Updates ``stats``."""
    import torch
    got = _flat(kernel_grad(*args))
    again = _flat(kernel_grad(*args))
    loss_only = kernel_loss(*args)
    want = _flat(plain_grad(*args))
    want_loss = plain_loss(*args)
    torch.cuda.synchronize()

    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    net = slice(1, len(want) - n_lam)
    gmax = max(float(w.abs().max()) for w in want[net])
    err = float((got[0] - want[0]).abs().max())
    for g, w in zip(got[net], want[net]):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-6 * gmax)
        err = max(err, float((g - w).abs().max()))
    for g, w in zip(got[len(want) - n_lam:], want[len(want) - n_lam:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)
        err = max(err, float((g - w).abs().max()))
    torch.testing.assert_close(loss_only.reshape(1), got[0], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(loss_only, want_loss, rtol=1e-5, atol=0.0)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{tag}: two launches differ bitwise")
    lerr = float(abs(loss_only - want_loss))
    for name, e in ((grad_name, err), (loss_name, lerr)):
        stats.setdefault(name, {"max_abs_err": 0.0})
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], e)
    log(f"[kernels] {tag}: loss {float(got[0]):.6e} (plain "
        f"{float(want[0]):.6e}), grad max|err| {err:.3e} of max|g| "
        f"{gmax:.3e}, loss-only |err| {lerr:.3e}, bitwise repeatable")
    if time_it:
        t = {"grad": _median_ms(lambda: kernel_grad(*args)),
             "plain_grad": _median_ms(lambda: plain_grad(*args)),
             "loss": _median_ms(lambda: kernel_loss(*args)),
             "plain_loss": _median_ms(lambda: plain_loss(*args))}
        stats[grad_name].update(ms=t["grad"], plain_ms=t["plain_grad"])
        stats[loss_name].update(ms=t["loss"], plain_ms=t["plain_loss"])
        log(f"[kernels] {tag} median ms: {grad_name} {t['grad']:.4f} vs plain "
            f"{t['plain_grad']:.4f}; {loss_name} {t['loss']:.4f} vs plain "
            f"{t['plain_loss']:.4f}")


def phase_kernels(stats: dict) -> None:
    """3: the Burgers inference kernels against their plain versions."""
    from pinn_torch.ops import fused_train as ft

    for i, (layers, n_u, n_f) in enumerate(KERNEL_SHAPES):
        args = _kernel_inputs(layers, n_u, n_f, seed=100 + i)
        _check_pair(stats, f"{layers[1]}x{len(layers) - 2} N={n_u + n_f}",
                    "burgers_loss_grad", "burgers_loss",
                    lambda *a: ft.burgers_loss_grad(*a, NU),
                    lambda *a: ft.burgers_loss(*a, NU),
                    lambda *a: ft.burgers_loss_grad_plain(*a, NU),
                    lambda *a: ft.burgers_loss_plain(*a, NU),
                    args, time_it=i == 0)


def phase_ide_kernels(stats: dict) -> None:
    """3b: the identification kernels against their plain versions."""
    from pinn_torch.ops import fused_train as ft

    for i, (layers, n) in enumerate(IDE_SHAPES):
        for j, lam in enumerate(IDE_LAMBDAS):
            args = _ide_inputs(layers, n, lam, seed=200 + i)
            _check_pair(stats, f"ide {layers[1]}x{len(layers) - 2} N={n} "
                        f"lam={lam}", "burgers_ide_loss_grad",
                        "burgers_ide_loss", ft.burgers_ide_loss_grad,
                        ft.burgers_ide_loss, ft.burgers_ide_loss_grad_plain,
                        ft.burgers_ide_loss_plain, args, n_lam=1,
                        time_it=i == 0 and j == 0)


def phase_schrodinger_kernels(stats: dict) -> None:
    """3c: the Schrödinger kernels against their plain versions."""
    from pinn_torch.ops import fused_schrodinger as fs

    for i, (layers, n) in enumerate(SCHRODINGER_SHAPES):
        args = _schrodinger_inputs(layers, n, seed=300 + i)
        _check_pair(stats, f"schrodinger {layers[1]}x{len(layers) - 2} N={n}",
                    "schrodinger_sse_grad", "schrodinger_sse",
                    fs.schrodinger_sse_grad, fs.schrodinger_sse,
                    fs.schrodinger_sse_grad_plain, fs.schrodinger_sse_plain,
                    args, time_it=i == 0)


def _logged_runs(path):
    """The epoch losses of each Trainer run in a log file, as lists of
    (phase, epoch, loss); a run ends at its "end" record."""
    runs, cur = [], []
    with open(path) as fh:
        for rec in map(json.loads, fh):
            if rec.get("event") == "epoch":
                cur.append((rec["phase"], rec["epoch"], rec["loss"]))
            elif rec.get("event") == "end":
                runs.append(cur)
                cur = []
    return runs


def _fmt(losses):
    return ", ".join(f"{p}={e}:{l:.4e}" for p, e, l in losses)


def _check_falls(tag, losses):
    first, last = losses[0][2], losses[-1][2]
    if not last < first:
        raise AssertionError(f"{tag}: loss did not fall: {first} -> {last}")


def _reset_counts():
    from pinn_torch.ops import fused_schrodinger as fs
    from pinn_torch.ops import fused_train as ft
    ft.n_launch_loss_grad = ft.n_launch_loss = 0
    ft.n_launch_ide_loss_grad = ft.n_launch_ide_loss = 0
    fs.n_launch_sse_grad = fs.n_launch_sse = 0


def _read_counts(names):
    from pinn_torch.ops import fused_schrodinger as fs
    from pinn_torch.ops import fused_train as ft
    counts = {"burgers_loss_grad": ft.n_launch_loss_grad,
              "burgers_loss": ft.n_launch_loss,
              "burgers_ide_loss_grad": ft.n_launch_ide_loss_grad,
              "burgers_ide_loss": ft.n_launch_ide_loss,
              "schrodinger_sse_grad": fs.n_launch_sse_grad,
              "schrodinger_sse": fs.n_launch_sse}
    launches = {n: counts[n] for n in names}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    return launches


def _check_finite(values):
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite value in the results: {values}")


def _param_maxes(params):
    from pinn_torch.params import leaves
    return [float(a.abs().max()) for a in leaves(params)]


def _rates(timing, adam_steps):
    return adam_steps / timing["adam_s"], timing["lbfgs_iters"] / timing["lbfgs_s"]


def phase_main_path() -> dict:
    """4: two stages of the Burgers inference recipe."""
    import torch
    from pinn_torch.experiments import inf_cont_burgers

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

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r1 = inf_cont_burgers.run(stage1)
    torch.cuda.synchronize()
    s1_seconds = time.perf_counter() - t0
    launches = _read_counts(["burgers_loss_grad", "burgers_loss"])
    log(f"[main] stage 1 launches: {launches}")

    losses1, = _logged_runs(stage1["log_file"])
    log(f"[main] stage 1 logged losses: {_fmt(losses1)}")
    _check_falls("stage 1", losses1)
    adam_rate, lbfgs_rate = _rates(r1["timing"], stage1["tf_epochs"])
    log(f"[main] stage 1: rel-L2 {r1['error']:.6e}, {s1_seconds:.2f} s, "
        f"Adam {adam_rate:.2f} steps/s, L-BFGS {lbfgs_rate:.2f} iters/s "
        f"({r1['timing']['lbfgs_iters']} iterations)")

    t0 = time.perf_counter()
    r2 = inf_cont_burgers.run(stage2)
    torch.cuda.synchronize()
    s2_seconds = time.perf_counter() - t0
    losses2, = _logged_runs(stage2["log_file"])
    log(f"[main] stage 2 (float64): rel-L2 {r2['error']:.6e}, "
        f"{s2_seconds:.2f} s, logged losses: {_fmt(losses2)}")

    values = [r1["error"], r2["error"], adam_rate, lbfgs_rate,
              *[l for _, _, l in losses1 + losses2]]
    for r in (r1, r2):
        values += [float(np.max(np.abs(r["u_pred"]))),
                   float(np.max(np.abs(r["f_pred"]))), *_param_maxes(r["params"])]
    _check_finite(values)
    return launches


def phase_ide_main_path() -> dict:
    """4b: the identification recipe, clean and noisy cases, two stages."""
    import torch
    from pinn_torch.experiments import ide_cont_burgers

    ckpt = os.path.join(WORK_DIR, "ide_stage1.npz")
    stage1 = {"device": "cuda", "fused_residual": True,
              "nt_vector_dtype": "float64", "tf_epochs": 100,
              "nt_epochs": 100, "save_checkpoint": ckpt,
              "log_file": os.path.join(WORK_DIR, "ide_stage1.jsonl")}
    stage2 = {"device": "cuda", "dtype": "float64", "nt_dir_impl": "matrix",
              "init_checkpoint": ckpt, "tf_epochs": 0, "nt_epochs": 50,
              "log_file": os.path.join(WORK_DIR, "ide_stage2.jsonl")}

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r1 = ide_cont_burgers.run(stage1)
    torch.cuda.synchronize()
    s1_seconds = time.perf_counter() - t0
    launches = _read_counts(["burgers_ide_loss_grad", "burgers_ide_loss"])
    log(f"[ide] stage 1 launches: {launches}")

    runs1 = _logged_runs(stage1["log_file"])
    values = []
    for case, losses in zip(("clean", "noisy"), runs1):
        log(f"[ide] stage 1 {case} logged losses: {_fmt(losses)}")
        _check_falls(f"ide stage 1 {case}", losses)
        values += [l for _, _, l in losses]
    rates = {case: _rates(r1["timing"][case], stage1["tf_epochs"])
             for case in ("clean", "noisy")}
    log(f"[ide] stage 1: {s1_seconds:.2f} s; " + "; ".join(
        f"{case}: Adam {a:.2f} steps/s, L-BFGS {b:.2f} iters/s "
        f"({r1['timing'][case]['lbfgs_iters']} iterations)"
        for case, (a, b) in rates.items()))

    t0 = time.perf_counter()
    r2 = ide_cont_burgers.run(stage2)
    torch.cuda.synchronize()
    s2_seconds = time.perf_counter() - t0
    for case, losses in zip(("clean", "noisy"), _logged_runs(stage2["log_file"])):
        log(f"[ide] stage 2 (float64) {case} logged losses: {_fmt(losses)}")
        values += [l for _, _, l in losses]
    for name, r in (("stage 1", r1), ("stage 2", r2)):
        log(f"[ide] {name}: lambda1 {r['lambdas'][0]:.6f}, lambda2 "
            f"{r['lambdas'][1]:.6e}; noisy lambda1 {r['lambdas_noisy'][0]:.6f}, "
            f"lambda2 {r['lambdas_noisy'][1]:.6e}; mean relative lambda "
            f"error {r['error']:.6e}")
        values += [*r["lambdas"], *r["lambdas_noisy"], r["error"],
                   float(np.max(np.abs(r["u_pred"]))),
                   *_param_maxes(r["params"]), *_param_maxes(r["params_noisy"])]
    log(f"[ide] stage 2: {s2_seconds:.2f} s")
    _check_finite(values + [x for ab in rates.values() for x in ab])
    return launches


def phase_schrodinger_main_path() -> dict:
    """4c: the Schrödinger recipe, two stages."""
    import torch
    from pinn_torch.experiments import inf_cont_schrodinger

    ckpt = os.path.join(WORK_DIR, "schrodinger_stage1.npz")
    stage1 = {"device": "cuda", "fused_residual": True,
              "nt_vector_dtype": "float64", "tf_epochs": 200,
              "nt_epochs": 100, "nt_line_search": "armijo",
              "nt_resample": 50, "log_frequency": 50,
              "save_checkpoint": ckpt,
              "log_file": os.path.join(WORK_DIR, "schrodinger_stage1.jsonl")}
    stage2 = {"device": "cuda", "dtype": "float64", "init_checkpoint": ckpt,
              "tf_epochs": 0, "nt_epochs": 25, "nt_val_every": 25,
              "log_frequency": 25,
              "log_file": os.path.join(WORK_DIR, "schrodinger_stage2.jsonl")}

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r1 = inf_cont_schrodinger.run(stage1)
    torch.cuda.synchronize()
    s1_seconds = time.perf_counter() - t0
    launches = _read_counts(["schrodinger_sse_grad", "schrodinger_sse"])
    log(f"[schrodinger] stage 1 launches: {launches}")

    losses1, = _logged_runs(stage1["log_file"])
    log(f"[schrodinger] stage 1 logged losses: {_fmt(losses1)}")
    _check_falls("schrodinger stage 1", losses1)
    adam_rate, lbfgs_rate = _rates(r1["timing"], stage1["tf_epochs"])
    log(f"[schrodinger] stage 1: rel-L2 |h| {r1['error']:.6e}, "
        f"{s1_seconds:.2f} s, Adam {adam_rate:.2f} steps/s, L-BFGS "
        f"{lbfgs_rate:.2f} iters/s ({r1['timing']['lbfgs_iters']} iterations)")

    t0 = time.perf_counter()
    r2 = inf_cont_schrodinger.run(stage2)
    torch.cuda.synchronize()
    s2_seconds = time.perf_counter() - t0
    losses2, = _logged_runs(stage2["log_file"])
    log(f"[schrodinger] stage 2 (float64): rel-L2 |h| {r2['error']:.6e}, "
        f"{s2_seconds:.2f} s, logged losses: {_fmt(losses2)}")

    values = [r1["error"], r2["error"], r1["loss"], r2["loss"], adam_rate,
              lbfgs_rate, *[l for _, _, l in losses1 + losses2]]
    for r in (r1, r2):
        values += [float(np.max(np.abs(r["h_pred"]))), *_param_maxes(r["params"])]
    _check_finite(values)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # The port itself, before anything is printed: a copy of this script
    # without the repository stops here.
    import pinn_torch.experiments.ide_cont_burgers  # noqa: F401
    import pinn_torch.experiments.inf_cont_burgers  # noqa: F401
    import pinn_torch.experiments.inf_cont_schrodinger  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)

    smi = phase_card()
    phase_build()
    stats = {}
    phase_kernels(stats)
    phase_ide_kernels(stats)
    phase_schrodinger_kernels(stats)
    launches = {**phase_main_path(), **phase_ide_main_path(),
                **phase_schrodinger_main_path()}
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **stats[name]} for name, (src, replaces) in KERNELS.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
