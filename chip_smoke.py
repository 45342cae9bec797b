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
   width-40 [2, 40x8, 1], a ragged [2, 16, 1] and the edges of the
   narrow loss+grad kernel (pt_narrow.cuh, a block a 32-point tile):
   the flagship at N = 1, 31, 33 and 10,119, [2, 7, 33, 64, 1], the
   widest pack [2, 64x14, 1] and the most layers [2, 20x15, 1]; at
   every shape the loss-only loss bitwise the loss+grad loss; bitwise
   repeatability; median times at the flagship; ptxas's lines of the
   two narrow kernels (``burgers_loss_grad`` runs
   pt_narrow_loss_grad_kernel, ``burgers_loss`` pt_narrow_loss_kernel,
   both on the inference head), their launch records and the device ms
   a call of each kernel of a call (profiler trace).
3b. Burgers identification kernels vs plain, at [2, 20x8, 1] (N =
   2,000), [2, 20, 20, 20, 1] (N = 300), [2, 16, 1] (N = 1,017) and the
   narrow kernel's edges (the flagship at N = 1, 31, 33 and 2,023,
   [2, 7, 33, 64, 1], [2, 64x14, 1], [2, 20x15, 1]), for (lambda1, log
   lambda2) = (0, -6) and (1.3, -4); at every shape the loss-only loss
   bitwise the loss+grad loss; times at N = 2,000; the ptxas lines,
   launch records and device ms a call of pt_narrow_loss_grad_kernel
   (``burgers_ide_loss_grad``) and pt_narrow_loss_kernel
   (``burgers_ide_loss``) on the identification head, as in 3.
3c. Schrödinger kernels vs plain, at [2, 100x4, 2] (N = 20,000 and
   300), [2, 32, 2] (N = 512) and the edges of the tiled kernels
   (32-point tiles): [2, 100x4, 2] at N = 1, 31, 33 and 4,231 (more
   tiles than one wave of blocks), [2, 128, 128, 2] (N = 4,231; the
   widest net) and [2, 100, 2] (N = 1,000; one hidden layer); at [2,
   100x4, 2] the loss-only kernel's loss bitwise the loss+grad
   kernel's; times at N = 20,000 with the share of the bound; ptxas's
   registers and spills of both tiled kernels (loss+grad, loss only),
   and the grid, block, registers and shared memory of their launches
   at [2, 100x4, 2] and [2, 128, 128, 2] from a profiler trace.
3d. The six bf16-stream kernels vs their plain bf16 versions: the
   inference pair as in 3 (every shape, the loss bitwise, the ptxas
   lines, launch records and device times of the bf16 instances of
   both narrow kernels), the identification pair at [2, 20x8, 1] (N =
   2,000), [2, 16, 1] (N = 1,017) and the edges of 3b, as in 3b, the
   Schrödinger pair at [2, 100x4, 2] (N = 20,000), [2, 32, 2]
   (N = 512) and the six edges of 3c, the loss bitwise as in 3c;
   bitwise repeatability; times at each flagship.
3e. The v1 SSE pair and the three residual-evaluation kernels vs their
   plain versions: the SSE pair (pt_narrow.cuh's loss+grad kernel and
   its loss-only kernel) at [2, 20x8, 1] (N = 10,000), [2, 40x8, 1]
   (N = 1,124), [2, 16, 1] (N = 1,024) and the narrow kernels' edges of
   3, at every shape the loss-only loss bitwise the loss+grad loss, and
   at N = 10,000 both kernels' ptxas lines, launch records and device
   ms a call, as in 3; both Burgers residual layouts (pt_narrow.cuh's
   pt_narrow_eval_kernel, ``burgers_residual`` on the points-major
   policy, ``burgers_residual_fmajor`` on the features-major one, the
   two bitwise equal at every shape) at [2, 20x8, 1] on a
   200,000-point pool and on the flagship grid (25,600 points), at [2,
   20, 20, 1] (N = 700) and at the narrow kernel's edges (the flagship
   at N = 1, 31, 33; [2, 7, 33, 64, 1]; [2, 64x14, 1]); the
   Schrödinger residual (pt_tile.cuh's
   pt_tile_eval_kernel) at [2, 100x4, 2] on its grid (51,456 points),
   [2, 32, 32, 2] (N = 600) and the tiled kernel's edges ([2, 100x4, 2]
   at N = 1, 33; [2, 30, 30, 2]; [2, 100, 2]; [2, 128, 128, 2]);
   bitwise repeatability; times at the first shape of each (the
   residuals at the pool and the grid); the ptxas lines, launch record
   and device ms a call of both Burgers layouts' eval kernels at the
   pool and on the grid, and of the Schrödinger one on its grid, with
   its rounds of persistent tiles and the device ms of its last,
   partly full round.
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
4d. The bf16 warmup on the inference flagship: the campaign's mixed
   stage (``fused_residual: True, tf_net_dtype: "bfloat16"``, float64
   vectors, matrix direction): every bf16 launch is an Adam step, the
   L-BFGS phase runs the float32 kernels; then a ``fused_residual:
   "bf16"`` run, whose L-BFGS trials launch the bf16 loss-only kernel.
4e. Identification with ``fused_residual: "bf16"`` (clean and noisy
   cases): both phases on the bf16 kernels, none on the float32 ones.
4f. Schrödinger with ``fused_residual: True, tf_net_dtype: "bfloat16"``
   (Adam on the bf16 kernel), then a short ``fused_residual: "bf16"``
   run (Adam at lr 0.005).  The warmup takes the recipe's Adam; its
   final loss, after L-BFGS, must fall below its first.
4g. RAR on the inference flagship: a fused float32 stage with
   ``rar_pool: 200000`` (every resampling scores the pool with
   ``burgers_residual``, pt_narrow_eval_kernel, at least 3 draws), the same stage without RAR as
   the control of its rates, then a float64 ``rar_init`` stage from its
   checkpoint, scored by the eager residual; and the top-k set of one
   pool from the kernel's residuals against the plain version's.
4h. The facade on the v1 loss: a ``PhysicsInformedNN`` subclass whose
   loss is data MSE + ``make_burgers_sse`` / N_f at the flagship, Adam
   then L-BFGS; ``predict`` and ``export_serving`` round trip.
4i. The serving example: two members at the flagship width, scored by
   ``burgers_residual`` (pt_narrow_eval_kernel), exported as one
   artifact and served.
4j. Residual diagnostics: the features-major Burgers residual
   (pt_narrow_eval_kernel) on the flagship grid and the Schrödinger residual
   (pt_tile_eval_kernel) on its grid, under the nets trained in 4 and
   4c, against the eager residuals.
4k-4n. The discrete-time IRK families at full width, on the eager
   loss (no hand-written kernel; every launch count must stay 0), each
   with its parameters on the card: 4k ``inf_disc_burgers.run`` at [1,
   50x3, 501], q = 500, N_n = 250; 4l ``ide_disc_burgers.run`` at [1,
   50x3, 81], q = 81, N_0 = 199, N_1 = 201, clean and noisy cases; 4m
   ``inf_disc_allencahn.run`` at [1, 200x4, 101], q = 100, N_n = 200:
   each the campaign's float32 stage (float64 L-BFGS vectors, matrix
   direction) cut to 100 Adam steps + 100 L-BFGS iterations, then 50
   float64 (``net_impl: "df32"``) iterations from its checkpoints; 4n
   ``ide_disc_kdv.run`` at [1, 50x3, 50], q = 50, N_0 = 199, N_1 =
   201, clean and noisy, its one float32 stage cut to 100 + 100.  Each
   prints its error (rel-L2, or the lambda pairs and the mean relative
   lambda error), its wall-clock and its Adam and L-BFGS rates.
4o. Navier–Stokes psi–p identification at full width, on the eager
   13-stream loss (no hand-written kernel; every launch count must stay
   0): ``ide_cont_navierstokes.run`` on the spectral DNS at its default
   grid (128 x 128 x 41 = 671,744 points) with the campaign's [3, 40x8,
   2] net and N_u = 10,000, clean and noisy cases; the campaign's stage
   (float32, float64 L-BFGS vectors, matrix direction) cut to 100 Adam
   steps + 100 L-BFGS iterations, then 20 float64 (``net_impl:
   "df32"``) iterations from its checkpoints with a separate
   collocation set (``N_f: 20000``) and best-iterate selection
   (``nt_val_every: 10``).  Prints the lambda pairs, the mean relative
   lambda error, the rel-L2 of u, v and the gauge-adjusted p on the
   full grid, and each stage's wall-clock and Adam and L-BFGS rates.
4p. The flagship with ``trace_dir`` (the Trainer wraps ``fit`` in
   ``torch.profiler``, CPU and CUDA activity, one Chrome-trace JSON):
   ``inf_cont_burgers.run`` at [2, 20x8, 1], N_u = 100, N_f = 10,000,
   fused float32, float64 L-BFGS vectors, the experiment's Armijo
   search (its trials launch row 2), 50 Adam steps + 20 L-BFGS
   iterations.  The trace is
   read and deleted: the launches of rows 1 and 2's kernels in it
   (``pt_narrow_loss_grad_kernel``, ``pt_narrow_loss_kernel``) must
   equal the launch counters less the run's closing loss evaluation,
   which falls after ``fit``.  Then, each traced alone, an Adam-only run
   (50 steps) and an L-BFGS-only run (20 iterations from the first
   run's checkpoint), and the same two for a few steps of 4k
   (``inf_disc_burgers`` at [1, 50x3, 501]: 20 + 10) and 4o
   (Navier–Stokes at [3, 40x8, 2], N_u = 10,000, clean and noisy
   cases: 3 + 2, for the trace's size), where no kernel
   of ours may appear in the trace or on the counters.  For each it
   prints the busy share: the union of the device's kernel, memcpy and
   memset intervals over the traced wall window (the first event's
   start to the last one's end), with the Adam ms a step of the same
   run untraced beside the traced one.
4q. ``custom_pde_example.run`` (the heat equation on the facade's
   ``loss`` and ``taylor`` hooks) at the JAX end-to-end test's schedule,
   100 Adam + 300 L-BFGS: rel-L2 under 7e-3.
4r. ``run_campaign.main(["inf_cont_burgers", "--quick", "--f32"])``:
   exit 0, every stage reported float32 with a finite error.
4s. The measuring part of ``inf_cont_burgers_bench`` at ``--quick``
   (the PINN, then plain networks on 50/200/400 domain points and
   50/100 boundary points), with no figure: every error finite, and
   matplotlib never imported.
4t. The data-parallel tier (``pinn_torch.parallel``): (a)
   ``make_burgers_loss_dp`` on four shards of ``cuda:0`` at the
   flagship (2,500 collocation + the 100 data points a shard) against
   ``make_burgers_loss`` on the whole batch from the same weights (the
   loss to rtol 1e-6, the gradients to rtol 2e-5 / atol 1e-7), row 1
   counted exactly 4 a call with gradients and row 2 4 a call without,
   two calls bitwise equal; the same for ``make_schrodinger_loss_dp``
   at [2, 100x4, 2], N_f = 20,000 (rows 7 and 8); the Adam step's ms
   for one launch, one shard and four shards, in turns; (b) a
   world-size-1 NCCL group (``init_distributed``): one Adam step of the
   fused flagship DP loss, bitwise the in-process one-shard step; (c)
   ``inf_cont_burgers`` and ``inf_cont_schrodinger`` with ``tpu_mesh:
   true, fused_residual: true`` (one shard on a one-card machine), 50
   Adam steps + 50 L-BFGS iterations, beside the same run unsharded:
   the loss falls, the launches of rows 1 + 2 (7 + 8) equal the Adam
   steps + the L-BFGS evaluations + the closing loss, and the counts
   and logged losses are bitwise the unsharded run's; both runs' rates.
4u. Tensor parallelism (``make_mesh_2d``, ``shard_params_tp``,
   ``pinn_torch.parallel.tp``) on a (2, 2) mesh of ``cuda:0``, four
   shards on one card: (a) TP+DP loss and gradients (``data_parallel``
   over the data rows, the net placed over the model columns) at full
   width against the unsharded eager loss from the same weights, for
   the flagship (N_u = 100, N_f = 10,000), Schrödinger [2, 100x4, 2]
   (N_f = 20,000; its width-2 head column-split), Navier–Stokes [3,
   40x8, 2] (N_u = 10,000; the head split too) and KdV's order-3 stream
   [1, 50x3, 50] (200 + 200 points, its sum loss scaled by the two data
   shards): the loss to rtol 1e-6, the gradients to rtol 2e-5 / atol
   1e-7 * max|g|, two calls bitwise equal, the Adam step's ms for both
   in turns; (b) a ``Trainer`` on TP parameters, 50 Adam steps + 20
   L-BFGS iterations (Armijo) on the flagship, beside the unsharded
   run: both losses fall, the final losses within 5e-2, the ms a step
   of each phase; (c) ``inf_cont_burgers.run`` with ``dtype:
   "bfloat16"`` at the flagship, 50 + 50: the loss falls, the
   parameters stay bf16; no kernel of ours launches in (a)-(c); (d)
   ``graft_entry.dryrun_multichip(4, "cuda")``: eager DP, fused DP (its
   only launches: rows 1 and 2), TP+DP on a 2 x 2 mesh, two gloo
   processes.
Each main path runs with every launch count set to 0 just before its
fused stage; every kernel of the path must have launched by its end
(4k-4o: none may have), the logged loss must fall and every reported
number must be finite.

Bounds.  Each kernel's ``bound_ms`` is the larger of its bytes (inputs
read once, outputs written once) over the card's 3.35 TB/s and its
operations over the card's peak: for the float32 kernels all of them
at the 67 TFLOP/s float32 rate; for the bf16 ones the layer products
(bf16 operands, float32 sums) at the 989 TFLOP/s bf16 tensor-core rate
and the elementwise work at 67 TFLOP/s; the residual kernels read each
point once and write its residual once.  No single PyTorch call
computes a fused loss with all its gradients, or a residual with its
Taylor streams, so ``library_ms`` is null.

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
from collections import Counter

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
# The edges of the narrow loss+grad kernel (pt_narrow.cuh, a block a
# 32-point tile), as (layers, N): one point, a tile less or more one
# point, the flagship's 316 tiles and 7 points more, hidden widths that
# are not multiples of 4, the widest pack and the most layers.
NARROW_EDGES = [(FLAGSHIP, 1), (FLAGSHIP, 31), (FLAGSHIP, 33),
                (FLAGSHIP, 316 * 32 + 7), ([2, 7, 33, 64, 1], 1000),
                ([2] + [64] * 14 + [1], 1000), ([2] + [20] * 15 + [1], 1000)]
IDE_SHAPES = [(FLAGSHIP, 2000), ([2, 20, 20, 20, 1], 300), ([2, 16, 1], 1017)]
# The same edges for the identification head, whose flagship is 63 tiles.
IDE_EDGES = NARROW_EDGES[:3] + [(FLAGSHIP, 63 * 32 + 7)] + NARROW_EDGES[4:]
IDE_LAMBDAS = [(0.0, -6.0), (1.3, -4.0)]
SCHRODINGER_SHAPES = [(S_FLAGSHIP, 20000), (S_FLAGSHIP, 300), ([2, 32, 2], 512)]
SSE_SHAPES = [(FLAGSHIP, 10000), (WIDE, 1124), ([2, 16, 1], 1024)]
RAR_POOL = 200000            # the P9 probe's candidate pool
# The residual entries' shapes, the main paths' first, then the block-
# tiled kernels' edges: one point, a tile less or more one point, hidden
# widths that are not multiples of 4, the widest pack (Burgers), one
# hidden layer and the widest net (Schrödinger).
RESIDUAL_SHAPES = [(FLAGSHIP, RAR_POOL), (FLAGSHIP, "grid"),
                   ([2, 20, 20, 1], 700), (FLAGSHIP, 1), (FLAGSHIP, 31),
                   (FLAGSHIP, 33), ([2, 7, 33, 64, 1], 1000),
                   ([2] + [64] * 14 + [1], 1000)]
S_RESIDUAL_SHAPES = [(S_FLAGSHIP, "grid"), ([2, 32, 32, 2], 600),
                     (S_FLAGSHIP, 1), (S_FLAGSHIP, 33), ([2, 30, 30, 2], 1000),
                     ([2, 100, 2], 1000), ([2, 128, 128, 2], 4231)]
WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
BURGERS_SRC = "pinn_torch/csrc/burgers_train.cu"
SCHRODINGER_SRC = "pinn_torch/csrc/schrodinger_train.cu"
RESIDUAL_SRC = "pinn_torch/csrc/residual_eval.cu"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    **{name + sfx: entry
       for name, entry in {
           "burgers_loss_grad": (BURGERS_SRC, "pinn/ops/pallas_train.py:524"),
           "burgers_loss": (BURGERS_SRC, "pinn/ops/pallas_train.py:576"),
           "burgers_ide_loss_grad": (BURGERS_SRC,
                                     "pinn/ops/pallas_train.py:847"),
           "burgers_ide_loss": (BURGERS_SRC, "pinn/ops/pallas_train.py:906"),
           "schrodinger_sse_grad": (SCHRODINGER_SRC,
                                    "pinn/ops/pallas_schrodinger.py:95"),
           "schrodinger_sse": (SCHRODINGER_SRC,
                               "pinn/ops/pallas_schrodinger.py:70"),
       }.items()
       for sfx in ("", "_bf16")},
    "burgers_sse_grad": (BURGERS_SRC, "pinn/ops/pallas_train.py:305"),
    "burgers_sse": (BURGERS_SRC, "pinn/ops/pallas_train.py:277"),
    "burgers_residual": (RESIDUAL_SRC, "pinn/ops/pallas_residual.py:55"),
    "burgers_residual_fmajor": (RESIDUAL_SRC,
                                "pinn/ops/pallas_residual.py:107"),
    "schrodinger_residual": (RESIDUAL_SRC, "pinn/ops/pallas_residual.py:248"),
}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12             # float32 outside the tensor cores
BF16_TC_FLOPS = 989e12        # bf16 tensor cores, dense
FWD_EW, BWD_EW = 12, 40       # elementwise operations per hidden neuron
                              # and point (tanh and stream recombination;
                              # its adjoint and the rematerialisation)
TRAINED = {}                  # nets trained by phases 4 and 4c, for 4j
NS_LAYERS = [3] + [40] * 8 + [2]   # the Navier–Stokes campaign recipe's net
NS_GRID = 128 * 128 * 41           # the spectral DNS's default grid
# Device activity in a torch.profiler Chrome trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


def _kernel_inputs(layers, n_u, n_f, seed, n=None):
    """Seeded numpy weights and points, prepared for the inference
    kernels on the card; with ``n``, only the last ``n`` points."""
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
    if n is not None:
        a0, aux = a0[:, -n:].contiguous(), aux[:, -n:].contiguous()
    return (a0, aux, *ft._prep(params, vx, vt))


def _edge_inputs(layers, n, seed):
    """_kernel_inputs for ``n`` points, a third of them data points."""
    n_u = max(1, n // 3)
    return _kernel_inputs(layers, n_u, n - n_u + 1, seed, n=n)


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


def _bound(layers, n, grads, bf16, n_aux, n_extra=0):
    """(bound_ms, bound_by) of one call of a fused kernel at ``layers``
    and ``n`` points: the larger of its bytes over the memory rate and
    its operations over the peak rates (module docstring)."""
    hidden, n_out = layers[1:-1], layers[-1]
    pairs = list(zip(hidden[:-1], hidden[1:])) + [(hidden[-1], n_out)]
    mm = 4 * hidden[0] + sum(8 * a * b for a, b in pairs)    # forward
    ew = FWD_EW * sum(hidden)
    if grads:  # dW0 on the value stream; dW and input adjoints above it
        mm += 4 * hidden[0] + sum(16 * a * b for a, b in pairs)
        ew += BWD_EW * sum(hidden)
    mm, ew = mm * n, ew * n
    n_weights = sum(a * b + b for a, b in zip(layers[:-1], layers[1:])) \
        + 2 * hidden[0]
    n_bytes = 4 * ((2 + n_aux) * n + n_weights + n_extra
                   + (1 + n_weights + n_extra if grads else 1))
    t_ops = mm / BF16_TC_FLOPS + ew / F32_FLOPS if bf16 else (mm + ew) / F32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def _check_bf16_grads(tag, got, want):
    """bf16 gradient bars: rel-L2 <= 1e-2 and cosine >= 0.9999."""
    import torch
    g, w = torch.cat(got), torch.cat(want)
    rel = float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
    cos = float(g @ w / (torch.linalg.norm(g) * torch.linalg.norm(w)))
    if not (rel <= 1e-2 and cos >= 0.9999):
        raise AssertionError(f"{tag}: bf16 gradients rel-L2 {rel:.3e}, "
                             f"cosine {cos:.6f}")
    return rel, cos


def _check_pair(stats, tag, grad_name, loss_name, kernel_grad, kernel_loss,
                plain_grad, plain_loss, args, layers, n_aux, n_lam=0,
                time_it=False, bf16=False, bitwise_loss=False):
    """Hold the loss+grad and loss-only kernels to their plain versions
    on ``args`` (a net of ``layers``; ``n_aux`` aux rows).  float32:
    loss rtol 1e-5; net gradients rtol 5e-4 with atol 5e-6 * max|g|;
    the last ``n_lam`` gradient pieces (the lambda adjoints) rtol 1e-4;
    the loss-only kernel to the loss+grad one at rtol 1e-6, or bitwise
    with ``bitwise_loss`` (f32 and bf16).  bf16 streams (the same
    roundings, summed in another order, which can move a rounding):
    losses rtol 2e-3, the net gradients and the lambda adjoints each
    rel-L2 <= 1e-2 and cosine >= 0.9999.  Two launches bitwise equal.
    Updates ``stats``; with ``time_it`` the times and the bound at this
    shape."""
    import torch
    got = _flat(kernel_grad(*args))
    again = _flat(kernel_grad(*args))
    loss_only = kernel_loss(*args)
    want = _flat(plain_grad(*args))
    want_loss = plain_loss(*args)
    torch.cuda.synchronize()

    net = slice(1, len(want) - n_lam)
    lam = slice(len(want) - n_lam, len(want))
    gmax = max(float(w.abs().max()) for w in want[net])
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if bf16:
        torch.testing.assert_close(got[0], want[0], rtol=2e-3, atol=0.0)
        torch.testing.assert_close(loss_only, want_loss, rtol=2e-3, atol=0.0)
        rel, cos = _check_bf16_grads(tag, got[net], want[net])
        if n_lam:
            _check_bf16_grads(tag + " lambda", got[lam], want[lam])
        bars = f"grad rel-L2 {rel:.3e}, cosine {cos:.7f}"
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
        for g, w in zip(got[net], want[net]):
            torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-6 * gmax)
        for g, w in zip(got[lam], want[lam]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)
        if not bitwise_loss:
            torch.testing.assert_close(loss_only.reshape(1), got[0],
                                       rtol=1e-6, atol=0.0)
        torch.testing.assert_close(loss_only, want_loss, rtol=1e-5, atol=0.0)
        bars = "within the float32 bars"
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{tag}: two launches differ bitwise")
    if bitwise_loss:
        if not torch.equal(loss_only.reshape(1), got[0]):
            raise AssertionError(f"{tag}: loss-only {float(loss_only)!r} is "
                                 f"not the loss+grad loss {float(got[0])!r}")
        bars += ", loss-only = loss+grad loss bitwise"
    lerr = float(abs(loss_only - want_loss))
    for name, e in ((grad_name, err), (loss_name, lerr)):
        stats.setdefault(name, {"max_abs_err": 0.0})
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], e)
    log(f"[kernels] {tag}: loss {float(got[0]):.6e} (plain "
        f"{float(want[0]):.6e}), grad max|err| {err:.3e} of max|g| "
        f"{gmax:.3e}, {bars}, loss-only {float(loss_only):.6e} (plain "
        f"{float(want_loss):.6e}), bitwise repeatable")
    if time_it:
        n = args[0].shape[1]
        t = {"grad": _median_ms(lambda: kernel_grad(*args)),
             "plain_grad": _median_ms(lambda: plain_grad(*args)),
             "loss": _median_ms(lambda: kernel_loss(*args)),
             "plain_loss": _median_ms(lambda: plain_loss(*args))}
        for name, kind, grads in ((grad_name, "grad", True),
                                  (loss_name, "loss", False)):
            bound_ms, bound_by = _bound(layers, n, grads, bf16, n_aux,
                                        2 * n_lam if grads else 2 * (n_lam > 0))
            stats[name].update(ms=t[kind], plain_ms=t["plain_" + kind],
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=None)
            log(f"[kernels] {tag} {name}: median {t[kind]:.4f} ms, plain "
                f"{t['plain_' + kind]:.4f} ms, bound {bound_ms:.5f} ms "
                f"({bound_by}; {bound_ms / t[kind]:.2%} of it)")


def _shape_tag(layers, n):
    return f"{layers[1]}x{len(layers) - 2} N={n}"


def phase_kernels(stats: dict, bf16: bool = False) -> None:
    """3 (3d with ``bf16``): the Burgers inference kernels against their
    plain versions, the loss-only loss bitwise the loss+grad one at
    every shape; the ptxas lines, launch records and device times of
    both narrow kernels on the inference head."""
    from pinn_torch.ops import fused_train as ft
    sfx = "_bf16" if bf16 else ""
    plain_grad = (ft.burgers_loss_grad_bf16_plain if bf16
                  else ft.burgers_loss_grad_plain)
    plain_loss = ft.burgers_loss_bf16_plain if bf16 else ft.burgers_loss_plain

    def grad(*a):
        return ft.burgers_loss_grad(*a, NU, bf16=bf16)

    def loss(*a):
        return ft.burgers_loss(*a, NU, bf16=bf16)

    cases = [(layers, n_u + n_f, _kernel_inputs(layers, n_u, n_f, seed=100 + i))
             for i, (layers, n_u, n_f) in enumerate(KERNEL_SHAPES)]
    cases += [(layers, n, _edge_inputs(layers, n, seed=700 + i))
              for i, (layers, n) in enumerate(NARROW_EDGES)]
    for i, (layers, n, args) in enumerate(cases):
        _check_pair(stats, sfx[1:] + " " + _shape_tag(layers, n),
                    "burgers_loss_grad" + sfx, "burgers_loss" + sfx, grad,
                    loss, lambda *a: plain_grad(*a, NU),
                    lambda *a: plain_loss(*a, NU),
                    args, layers, n_aux=3, time_it=i == 0, bf16=bf16,
                    bitwise_loss=True)

    _report_narrow(stats, bf16, "BurgersInfHead",
                   [("pt_narrow_loss_grad_kernel", "burgers_loss_grad", grad),
                    ("pt_narrow_loss_kernel", "burgers_loss", loss)],
                   cases[0][2], _shape_tag(FLAGSHIP, cases[0][1]))


def _report_narrow(stats, bf16, head, calls, args, shape):
    """For each (kernel template, entry, call) of ``calls`` on ``head``:
    ptxas's lines of the kernel, its launch record in one call on
    ``args`` and the device ms a call of each kernel the call launches
    (profiler traces), beside the median through the wrapper."""
    sfx = "_bf16" if bf16 else ""
    for kernel, name, fn in calls:
        for line in _ptxas_lines(kernel, bf16, head):
            log(f"[kernels] {name}{sfx} ptxas ({kernel}): {line}")
        rec, = _launch_records(kernel, [lambda: fn(*args)])
        log(f"[kernels] {name}{sfx} launch of {kernel} at {shape} "
            f"(profiler trace): {rec}")
        dev = _device_ms(lambda: fn(*args))
        log(f"[kernels] {name}{sfx} device ms a call at {shape} (profiler "
            f"trace, beside the median {stats[name + sfx]['ms']:.4f} ms "
            f"through the wrapper): total {sum(dev.values()):.5f}; "
            + ", ".join(f"{k} {v:.5f}" for k, v in dev.items()))


def phase_ide_kernels(stats: dict, bf16: bool = False,
                      shapes=IDE_SHAPES + IDE_EDGES) -> None:
    """3b (3d with ``bf16``): the identification kernels against their
    plain versions, the loss-only loss bitwise the loss+grad one at
    every shape; the ptxas lines, launch records and device times of
    both narrow kernels on the identification head at the first
    shape."""
    from pinn_torch.ops import fused_train as ft
    sfx = "_bf16" if bf16 else ""
    plain_grad = (ft.burgers_ide_loss_grad_bf16_plain if bf16
                  else ft.burgers_ide_loss_grad_plain)
    plain_loss = (ft.burgers_ide_loss_bf16_plain if bf16
                  else ft.burgers_ide_loss_plain)

    def grad(*a):
        return ft.burgers_ide_loss_grad(*a, bf16=bf16)

    def loss(*a):
        return ft.burgers_ide_loss(*a, bf16=bf16)

    for i, (layers, n) in enumerate(shapes):
        for j, lam in enumerate(IDE_LAMBDAS):
            args = _ide_inputs(layers, n, lam, seed=200 + i)
            _check_pair(stats, f"ide{sfx} {_shape_tag(layers, n)} lam={lam}",
                        "burgers_ide_loss_grad" + sfx, "burgers_ide_loss" + sfx,
                        grad, loss, plain_grad, plain_loss, args, layers,
                        n_aux=3, n_lam=1, time_it=i == 0 and j == 0, bf16=bf16,
                        bitwise_loss=True)
    layers, n = shapes[0]
    _report_narrow(stats, bf16, "BurgersIdeHead",
                   [("pt_narrow_loss_grad_kernel", "burgers_ide_loss_grad", grad),
                    ("pt_narrow_loss_kernel", "burgers_ide_loss", loss)],
                   _ide_inputs(layers, n, IDE_LAMBDAS[0], seed=200),
                   _shape_tag(layers, n))


def _schrodinger_edges():
    """The edges of the tiled kernels (pt_tile.cuh), whose tile
    is the points of one partials row of the C interface: one point, a
    tile less or more one point, more tiles than one wave of blocks (132
    SMs), the widest net and one hidden layer."""
    from pinn_torch.ops.fused_train import TILE
    return [(S_FLAGSHIP, 1), (S_FLAGSHIP, TILE - 1), (S_FLAGSHIP, TILE + 1),
            (S_FLAGSHIP, 132 * TILE + 7), ([2, 128, 128, 2], 132 * TILE + 7),
            ([2, 100, 2], 1000)]


def phase_schrodinger_kernels(stats: dict, bf16: bool = False,
                              shapes=None) -> None:
    """3c (3d with ``bf16``): the Schrödinger kernels against their
    plain versions."""
    from pinn_torch.ops import fused_schrodinger as fs
    if shapes is None:
        shapes = SCHRODINGER_SHAPES + _schrodinger_edges()
    sfx = "_bf16" if bf16 else ""
    plain_grad = (fs.schrodinger_sse_grad_bf16_plain if bf16
                  else fs.schrodinger_sse_grad_plain)
    plain_loss = fs.schrodinger_sse_bf16_plain if bf16 else fs.schrodinger_sse_plain

    for i, (layers, n) in enumerate(shapes):
        args = _schrodinger_inputs(layers, n, seed=300 + i)
        _check_pair(stats, f"schrodinger{sfx} {_shape_tag(layers, n)}",
                    "schrodinger_sse_grad" + sfx, "schrodinger_sse" + sfx,
                    lambda *a: fs.schrodinger_sse_grad(*a, bf16=bf16),
                    lambda *a: fs.schrodinger_sse(*a, bf16=bf16),
                    plain_grad, plain_loss, args, layers, n_aux=0,
                    time_it=i == 0, bf16=bf16,
                    bitwise_loss=layers == S_FLAGSHIP)
    shapes = [SCHRODINGER_SHAPES[0], ([2, 128, 128, 2], 4231)]
    inputs = [_schrodinger_inputs(layers, n, seed=300) for layers, n in shapes]
    for kernel, name, fn in (("pt_tile_loss_grad_kernel", "schrodinger_sse_grad",
                              fs.schrodinger_sse_grad),
                             ("pt_tile_loss_kernel", "schrodinger_sse",
                              fs.schrodinger_sse)):
        for line in _ptxas_lines(kernel, bf16):
            log(f"[kernels] {name}{sfx} ptxas ({kernel}): {line}")
        recs = _launch_records(kernel, [
            lambda a=a, fn=fn: fn(*a, bf16=bf16) for a in inputs])
        for (layers, n), rec in zip(shapes, recs):
            log(f"[kernels] {name}{sfx} launch of {kernel} at "
                f"{_shape_tag(layers, n)} (profiler trace): {rec}")


def _launch_records(kernel, fns, tries=3):
    """Grid, block, registers a thread and shared memory a block of the
    one launch of ``kernel`` in each call of ``fns``, as a
    torch.profiler (CUPTI) trace of the calls records them.  The trace
    has been seen to miss a launch now and then, so it is taken up to
    ``tries`` times; a record still missing reads "not traced".  What
    the kernel computes is checked elsewhere."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    keys = ("grid", "block", "registers per thread", "shared memory",
            "blocks per SM")
    path = os.path.join(WORK_DIR, "launch_trace.json")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                fn()
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        found = sorted((e for e in events if e.get("cat") == "kernel"
                        and kernel in e.get("name", "")),
                       key=lambda e: e["ts"])
        if len(found) == len(fns):
            return [{k: e.get("args", {}).get(k) for k in keys} for e in found]
    return ["not traced"] * len(fns)


def _device_ms(fn, reps=20) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by kernel
    name, from a torch.profiler (CUPTI) trace of ``reps`` calls after
    one outside it."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            name = re.sub(r"^void |\(anonymous namespace\)::|[<(].*$", "", e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def _ptxas_lines(kernel, bf16, head=""):
    """ptxas's lines (registers, stack, spills) for the float32 or bf16
    instance of the kernel template named ``kernel`` (on ``head``)."""
    from pinn_torch.ops import _build
    lines, keep = [], False
    for line in _build.library().log.splitlines():
        if "Compiling entry function" in line:
            keep = (kernel in line and head in line
                    and ("bfloat16" in line) == bf16)
        elif keep and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def phase_bf16_kernels(stats: dict) -> None:
    """3d: the six bf16-stream kernels against their plain versions."""
    phase_kernels(stats, bf16=True)
    phase_ide_kernels(stats, bf16=True,
                      shapes=[IDE_SHAPES[0], IDE_SHAPES[2], *IDE_EDGES])
    phase_schrodinger_kernels(stats, bf16=True,
                              shapes=[SCHRODINGER_SHAPES[0],
                                      SCHRODINGER_SHAPES[2],
                                      *_schrodinger_edges()])


def _bound_residual(layers, n):
    """(bound_ms, bound_by) of one residual-evaluation call: the forward
    of :func:`_bound` plus the head's few operations a point; bytes are
    the points read once, the weights once and the residuals written
    once."""
    hidden, n_out = layers[1:-1], layers[-1]
    pairs = list(zip(hidden[:-1], hidden[1:])) + [(hidden[-1], n_out)]
    ops = n * (4 * hidden[0] + sum(8 * a * b for a, b in pairs)
               + FWD_EW * sum(hidden) + 8 * n_out)
    n_weights = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
    n_bytes = 4 * (2 * n + n_weights + n_out * n)
    t_ops, t_bytes = ops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _sse_inputs(layers, n, seed):
    """Seeded weights and collocation points, prepared for the v1 SSE
    kernels on the card: (a0, z1row, z2row, wt_args)."""
    import torch
    from pinn_torch.ops import fused_train as ft

    rng = np.random.RandomState(seed)
    params = _weights(layers, rng)
    X_f = torch.as_tensor(LB + (UB - LB) * rng.rand(n, 2),
                          dtype=torch.float32, device="cuda")
    lb, ub, vx, vt = ft._tangents(LB, UB, "cuda")
    return (ft._normalise(X_f, lb, ub), *ft._prep(params, vx, vt))


def _grid(problem):
    """(X_star, lb, ub) of a problem's full grid, as numpy float32."""
    from pinn_torch.data import burgers_cont_inference, schrodinger_inference
    data = (burgers_cont_inference(100, 100) if problem == "burgers"
            else schrodinger_inference(50, 50, 100))
    return (data.X_star.astype(np.float32), data.lb.astype(np.float32),
            data.ub.astype(np.float32))


def _residual_cases(problem):
    """Phase 3e's seeded inputs of a problem's residual entries, one
    (layers, params, X, lb, ub) for each of its shapes (RESIDUAL_SHAPES,
    S_RESIDUAL_SHAPES): "grid" is the problem's full grid, a number that
    many points drawn in the box."""
    import torch
    X_grid, lb, ub = _grid(problem)
    shapes, seed = ((RESIDUAL_SHAPES, 500) if problem == "burgers"
                    else (S_RESIDUAL_SHAPES, 600))
    for i, (layers, n) in enumerate(shapes):
        rng = np.random.RandomState(seed + i)
        params = _weights(layers, rng)
        X = X_grid if n == "grid" else lb + (ub - lb) * rng.rand(n, 2)
        yield (layers, params,
               torch.as_tensor(X, dtype=torch.float32, device="cuda"), lb, ub)


def _report_residual(name, kernel, head, fn, shape, n_tiles=None):
    """ptxas's lines of a residual entry's kernel (on ``head``), its
    launch record in one call ``fn`` and the device ms a call of each
    kernel the call launches (profiler traces).  With ``n_tiles`` (a
    persistent grid): the rounds of tiles the grid takes, and the device
    ms of the kernel over the full rounds alone (N = rounds x grid x 32)
    beside the call's, the cost of a last, partly full round."""
    from pinn_torch.ops.fused_train import TILE
    for line in _ptxas_lines(kernel, False, head):
        log(f"[kernels] {name} ptxas ({kernel}): {line}")
    rec, = _launch_records(kernel, [fn])
    log(f"[kernels] {name} launch of {kernel} at {shape} (profiler trace): "
        f"{rec}")
    dev = _device_ms(fn)
    log(f"[kernels] {name} device ms a call at {shape} (profiler trace): "
        f"total {sum(dev.values()):.5f}; "
        + ", ".join(f"{k} {v:.5f}" for k, v in dev.items()))
    if n_tiles is None or not isinstance(rec, dict):
        return
    grid = rec["grid"][0]
    full, rest = divmod(n_tiles, grid)
    log(f"[kernels] {name} at {shape}: {n_tiles} tiles on {grid} persistent "
        f"blocks, {full} full rounds and one {rest / grid:.0%} full")
    if rest and kernel in dev:
        full_ms = _device_ms(lambda: fn(full * grid * TILE)).get(kernel)
        if full_ms is not None:
            log(f"[kernels] {name} {kernel} device ms at {full} full rounds "
                f"(N = {full * grid * TILE}): {full_ms:.5f}, against "
                f"{dev[kernel]:.5f} with the last round: it costs "
                f"{dev[kernel] - full_ms:.5f} ms")


def _check_residual(stats, tag, name, kernel, plain, params, X, layers, rtol,
                    atol, time_it=False):
    """A residual kernel against its plain version on the same inputs
    (outputs to ``rtol``/``atol``), two launches bitwise equal; with
    ``time_it`` the times and the bound at this shape."""
    import torch

    def flat(out):
        return torch.cat(out, dim=1) if isinstance(out, tuple) else out

    got, again = flat(kernel(params, X)), flat(kernel(params, X))
    want = flat(plain(params, X))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: two launches differ bitwise")
    err = float((got - want).abs().max())
    stats.setdefault(name, {"max_abs_err": 0.0})
    stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    log(f"[kernels] {tag}: max|err| {err:.3e} of max|f| "
        f"{float(want.abs().max()):.3e} (rtol {rtol:g}, atol {atol:g}), "
        f"bitwise repeatable")
    if time_it:
        ms = _median_ms(lambda: kernel(params, X))
        plain_ms = _median_ms(lambda: plain(params, X))
        bound_ms, bound_by = _bound_residual(layers, X.shape[0])
        stats[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
        log(f"[kernels] {tag} {name}: median {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")


def phase_v1_kernels(stats: dict) -> None:
    """3e: the v1 SSE pair and the residual-evaluation kernels against
    their plain versions; the SSE pair also at the narrow kernels'
    edges, the loss-only loss bitwise the loss+grad one at every shape,
    and both narrow kernels' ptxas lines, launch records and device
    times at the first shape; the two Burgers residual layouts bitwise
    equal at every shape, and the same report for the residual entries'
    kernels at the pool and the Burgers grid (both layouts) and on the
    Schrödinger grid."""
    import torch
    from pinn_torch.ops import fused_train as ft
    from pinn_torch.ops import residual as rs

    def grad(*a):
        return ft.burgers_sse_grad(*a, NU)

    def loss(*a):
        return ft.burgers_sse(*a, NU)

    for i, (layers, n) in enumerate(SSE_SHAPES + NARROW_EDGES):
        args = _sse_inputs(layers, n, seed=400 + i)
        _check_pair(stats, "sse " + _shape_tag(layers, n), "burgers_sse_grad",
                    "burgers_sse", grad, loss,
                    lambda *a: ft.burgers_sse_grad_plain(*a, NU),
                    lambda *a: ft.burgers_sse_plain(*a, NU),
                    args, layers, n_aux=0, time_it=i == 0, bitwise_loss=True)
    layers, n = SSE_SHAPES[0]
    _report_narrow(stats, False, "BurgersSseHead",
                   [("pt_narrow_loss_grad_kernel", "burgers_sse_grad", grad),
                    ("pt_narrow_loss_kernel", "burgers_sse", loss)],
                   _sse_inputs(layers, n, seed=400), _shape_tag(layers, n))

    layouts = (("burgers_residual", "RawPointsMajor"),
               ("burgers_residual_fmajor", "RawFeaturesMajor"))
    reported = []
    for i, (layers, params, X, lb, ub) in enumerate(_residual_cases("burgers")):
        shape = _shape_tag(layers, X.shape[0])
        for name, _ in layouts:
            kernel, plain = getattr(rs, name), getattr(rs, name + "_plain")
            _check_residual(stats, f"{name} {shape}",
                            name, lambda p, x: kernel(p, x, lb, ub, NU),
                            lambda p, x: plain(p, x, lb, ub, NU), params, X,
                            layers, rtol=2e-5, atol=1e-6, time_it=i == 0)
        f_points, f_features = (getattr(rs, name)(params, X, lb, ub, NU)
                                for name, _ in layouts)
        if not torch.equal(f_points, f_features):
            raise AssertionError(f"burgers residual {shape}: the two layouts "
                                 "differ bitwise")
        log(f"[kernels] burgers residual {shape}: both layouts bitwise equal")
        if i < 2:   # the pool and the grid
            reported.append((params, X, lb, ub, shape))
    for params, X, lb, ub, shape in reported:
        for name, policy in layouts:
            _report_residual(name, "pt_narrow_eval_kernel", policy,
                             lambda f=getattr(rs, name), p=params, x=X, lb=lb,
                             ub=ub: f(p, x, lb, ub, NU), shape)

    for i, (layers, params, X, lb, ub) in enumerate(_residual_cases("schrodinger")):
        _check_residual(stats, "schrodinger_residual "
                        + _shape_tag(layers, X.shape[0]), "schrodinger_residual",
                        lambda p, x: rs.schrodinger_residual(p, x, lb, ub),
                        lambda p, x: rs.schrodinger_residual_plain(p, x, lb, ub),
                        params, X, layers, rtol=2e-4, atol=2e-6, time_it=i == 0)
        if i == 0:
            grid = (params, X, lb, ub, _shape_tag(layers, X.shape[0]))
    params, X, lb, ub, shape = grid
    n = X.shape[0]
    _report_residual("schrodinger_residual", "pt_tile_eval_kernel",
                     "SchrodingerResidual",
                     lambda m=n: rs.schrodinger_residual(params, X[:m], lb, ub),
                     shape, n_tiles=-(-n // 32))


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


def _check_falls(tag, losses, result=None):
    first, last = losses[0][2], losses[-1][2]
    if not last < first:
        raise AssertionError(f"{tag}: loss did not fall: {first} -> {last}")


def _check_final_falls(tag, losses, result):
    """The Schrödinger recipe's Adam (lr 0.05, beta1 0.99) lifts the loss
    by two to three orders of magnitude over its first ~100 steps before
    it comes down (ROADMAP Queue 3), and L-BFGS may stop before its
    first log point, so the last logged loss can still lie on the
    spike's tail: the run's final loss, after L-BFGS, must fall below
    its first logged loss."""
    first = losses[0][2]
    log(f"[{tag}] final loss {result['loss']:.4e} (first logged {first:.4e}, "
        f"peak {max(l for _, _, l in losses):.4e})")
    if not result["loss"] < first:
        raise AssertionError(f"{tag}: loss did not fall: {first} -> "
                             f"final {result['loss']}")


_COUNT_BASE = {}   # the launch counters at the last _reset_counts()


def _reset_counts():
    global _COUNT_BASE
    from pinn_torch.utils import trace
    _COUNT_BASE = trace.counters()


def _counts() -> Counter:
    """The CUDA launches of each entry point since :func:`_reset_counts`
    (the ``launch.<entry>`` counters of ``pinn_torch.utils.trace``)."""
    from pinn_torch.utils import trace
    moved = trace.delta(_COUNT_BASE, trace.counters())
    return Counter({k[len("launch."):]: n for k, n in moved.items()
                    if k.startswith("launch.")})


def _read_counts(names):
    counts = _counts()
    launches = {n: counts[n] for n in names}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    return launches


def _expect_counts(tag, want: dict) -> None:
    """Every named count equals its expected value."""
    counts = _counts()
    got = {n: counts[n] for n in want}
    if got != want:
        raise AssertionError(f"{tag}: launch counts {got}, expected {want}")


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
              "tf_epochs": 100, "nt_epochs": 100, "nt_resample": 50,
              "log_frequency": 25, "save_checkpoint": ckpt,
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

    TRAINED["burgers"] = r1["params"]
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
    TRAINED["schrodinger"] = r1["params"]

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


def _run_stage(tag, run, hp, check=_check_falls):
    """One experiment run, timed on the host after a device sync;
    returns (result, seconds, logged runs).  ``check(tag, losses,
    result)`` holds each logged run (by default: its loss falls)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run(hp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    runs = _logged_runs(hp["log_file"])
    for i, losses in enumerate(runs):
        log(f"[{tag}] run {i} logged losses: {_fmt(losses)}")
        check(f"{tag} run {i}", losses, r)
    return r, seconds, runs


def phase_bf16_main_path() -> dict:
    """4d: the campaign's bf16-warmup mixed stage on the inference
    flagship, then a run on the bf16 kernels alone."""
    from pinn_torch.experiments import inf_cont_burgers

    mixed = {"device": "cuda", "layers": FLAGSHIP, "N_u": 100, "N_f": 10000,
             "fused_residual": True, "tf_net_dtype": "bfloat16",
             "nt_vector_dtype": "float64", "nt_dir_impl": "matrix",
             "nt_line_search": "wolfe", "nt_resample": 100,
             "tf_epochs": 200, "nt_epochs": 200, "log_frequency": 50,
             "log_file": os.path.join(WORK_DIR, "bf16_mixed.jsonl")}
    bf16 = {"device": "cuda", "layers": FLAGSHIP, "N_u": 100, "N_f": 10000,
            "fused_residual": "bf16", "nt_vector_dtype": "float64",
            "tf_epochs": 50, "nt_epochs": 50, "log_frequency": 25,
            "log_file": os.path.join(WORK_DIR, "bf16_only.jsonl")}

    _reset_counts()
    r1, s1, (losses1,) = _run_stage("bf16 mixed", inf_cont_burgers.run, mixed)
    # One bf16 loss+grad launch per Adam step and none elsewhere: the
    # L-BFGS phase, its line searches and the final loss are float32.
    _expect_counts("bf16 mixed", {"burgers_loss_grad_bf16": mixed["tf_epochs"],
                                  "burgers_loss_bf16": 0})
    mixed_counts = _read_counts(["burgers_loss_grad", "burgers_loss"])
    adam_rate, lbfgs_rate = _rates(r1["timing"], mixed["tf_epochs"])
    log(f"[bf16] mixed stage launches: {mixed_counts} + "
        f"{mixed['tf_epochs']} burgers_loss_grad_bf16 (the Adam steps)")
    log(f"[bf16] mixed stage: rel-L2 {r1['error']:.6e}, {s1:.2f} s, Adam "
        f"{adam_rate:.2f} steps/s, L-BFGS {lbfgs_rate:.2f} iters/s "
        f"({r1['timing']['lbfgs_iters']} iterations)")

    r2, s2, (losses2,) = _run_stage("bf16 only", inf_cont_burgers.run, bf16)
    _expect_counts("bf16 only", mixed_counts)   # no new float32 launch
    launches = _read_counts(["burgers_loss_grad_bf16", "burgers_loss_bf16"])
    adam2, lbfgs2 = _rates(r2["timing"], bf16["tf_epochs"])
    log(f"[bf16] bf16-only run: rel-L2 {r2['error']:.6e}, {s2:.2f} s, Adam "
        f"{adam2:.2f} steps/s, L-BFGS {lbfgs2:.2f} iters/s; path launches "
        f"{launches}")
    values = [r1["error"], r2["error"], r1["loss"], r2["loss"], adam_rate,
              lbfgs_rate, adam2, lbfgs2,
              *[l for _, _, l in losses1 + losses2]]
    for r in (r1, r2):
        values += [float(np.max(np.abs(r["u_pred"]))),
                   float(np.max(np.abs(r["f_pred"]))), *_param_maxes(r["params"])]
    _check_finite(values)
    return launches


def phase_ide_bf16_main_path() -> dict:
    """4e: identification on the bf16 kernels, clean and noisy cases."""
    from pinn_torch.experiments import ide_cont_burgers

    hp = {"device": "cuda", "fused_residual": "bf16",
          "nt_vector_dtype": "float64", "tf_epochs": 100, "nt_epochs": 100,
          "log_file": os.path.join(WORK_DIR, "ide_bf16.jsonl")}
    _reset_counts()
    r, seconds, runs = _run_stage("ide bf16", ide_cont_burgers.run, hp)
    _expect_counts("ide bf16", {"burgers_ide_loss_grad": 0,
                                "burgers_ide_loss": 0})
    launches = _read_counts(["burgers_ide_loss_grad_bf16",
                             "burgers_ide_loss_bf16"])
    rates = {case: _rates(r["timing"][case], hp["tf_epochs"])
             for case in ("clean", "noisy")}
    log(f"[ide bf16] launches: {launches}; {seconds:.2f} s; " + "; ".join(
        f"{case}: Adam {a:.2f} steps/s, L-BFGS {b:.2f} iters/s "
        f"({r['timing'][case]['lbfgs_iters']} iterations)"
        for case, (a, b) in rates.items()))
    log(f"[ide bf16] lambda1 {r['lambdas'][0]:.6f}, lambda2 "
        f"{r['lambdas'][1]:.6e}; noisy lambda1 {r['lambdas_noisy'][0]:.6f}, "
        f"lambda2 {r['lambdas_noisy'][1]:.6e}; mean relative lambda error "
        f"{r['error']:.6e}")
    _check_finite([*r["lambdas"], *r["lambdas_noisy"], r["error"],
                   float(np.max(np.abs(r["u_pred"]))),
                   *_param_maxes(r["params"]), *_param_maxes(r["params_noisy"]),
                   *[l for losses in runs for _, _, l in losses],
                   *[x for ab in rates.values() for x in ab]])
    return launches


def phase_schrodinger_bf16_main_path() -> dict:
    """4f: Schrödinger with the bf16 warmup, then on the bf16 kernels
    alone."""
    from pinn_torch.experiments import inf_cont_schrodinger

    warm = {"device": "cuda", "fused_residual": True,
            "tf_net_dtype": "bfloat16", "nt_vector_dtype": "float64",
            "tf_epochs": 200, "nt_epochs": 50, "log_frequency": 50,
            "log_file": os.path.join(WORK_DIR, "schrodinger_bf16_warm.jsonl")}
    # The recipe's Adam spikes the loss (_check_final_falls); this short run
    # takes a gentler one, so that its logged loss can fall within 20
    # steps.
    bf16 = {"device": "cuda", "fused_residual": "bf16", "tf_lr": 0.005,
            "tf_b1": 0.9, "nt_vector_dtype": "float64", "tf_epochs": 20,
            "nt_epochs": 20, "log_frequency": 10,
            "log_file": os.path.join(WORK_DIR, "schrodinger_bf16_only.jsonl")}
    _reset_counts()
    r1, s1, (losses1,) = _run_stage("schrodinger bf16 warmup",
                                    inf_cont_schrodinger.run, warm,
                                    check=_check_final_falls)
    _expect_counts("schrodinger bf16 warmup",
                   {"schrodinger_sse_grad_bf16": warm["tf_epochs"],
                    "schrodinger_sse_bf16": 0})
    warm_counts = _read_counts(["schrodinger_sse_grad", "schrodinger_sse"])
    adam_rate, lbfgs_rate = _rates(r1["timing"], warm["tf_epochs"])
    log(f"[schrodinger bf16] warmup stage launches: {warm_counts} + "
        f"{warm['tf_epochs']} schrodinger_sse_grad_bf16 (the Adam steps); "
        f"rel-L2 |h| {r1['error']:.6e}, {s1:.2f} s, Adam {adam_rate:.2f} "
        f"steps/s, L-BFGS {lbfgs_rate:.2f} iters/s "
        f"({r1['timing']['lbfgs_iters']} iterations)")

    r2, s2, (losses2,) = _run_stage("schrodinger bf16 only",
                                    inf_cont_schrodinger.run, bf16)
    _expect_counts("schrodinger bf16 only", warm_counts)
    launches = _read_counts(["schrodinger_sse_grad_bf16", "schrodinger_sse_bf16"])
    adam2, lbfgs2 = _rates(r2["timing"], bf16["tf_epochs"])
    log(f"[schrodinger bf16] bf16-only run: rel-L2 |h| {r2['error']:.6e}, "
        f"{s2:.2f} s, Adam {adam2:.2f} steps/s, L-BFGS {lbfgs2:.2f} iters/s; "
        f"path launches {launches}")
    values = [r1["error"], r2["error"], r1["loss"], r2["loss"], adam_rate,
              lbfgs_rate, adam2, lbfgs2,
              *[l for _, _, l in losses1 + losses2]]
    for r in (r1, r2):
        values += [float(np.max(np.abs(r["h_pred"]))), *_param_maxes(r["params"])]
    _check_finite(values)
    return launches


def phase_rar_main_path() -> dict:
    """4g: RAR on the inference flagship (a float32 stage scored by the
    residual kernel, its control without RAR, a float64 rar_init
    stage), and one pool's top-k set from the kernel against the plain
    version's."""
    import torch
    from pinn_torch.data import lhs
    from pinn_torch.experiments import inf_cont_burgers
    from pinn_torch.ops import residual as rs

    ckpt = os.path.join(WORK_DIR, "rar_stage1.npz")
    stage1 = {"device": "cuda", "layers": FLAGSHIP, "N_u": 100,
              "N_f": 10000, "fused_residual": True,
              "nt_vector_dtype": "float64", "nt_line_search": "wolfe",
              "tf_epochs": 100, "nt_epochs": 100, "nt_resample": 25,
              "log_frequency": 25, "rar_pool": RAR_POOL,
              "save_checkpoint": ckpt,
              "log_file": os.path.join(WORK_DIR, "rar_stage1.jsonl")}
    control = {**{k: v for k, v in stage1.items()
                  if k not in ("rar_pool", "save_checkpoint")},
               "log_file": os.path.join(WORK_DIR, "rar_control.jsonl")}
    # The P9 probe's refinement shape, cut to 25 iterations.
    stage2 = {"device": "cuda", "layers": FLAGSHIP, "N_u": 100,
              "N_f": 10000, "dtype": "float64", "nt_dir_impl": "matrix",
              "init_checkpoint": ckpt, "tf_epochs": 0, "nt_epochs": 25,
              "nt_line_search": "wolfe", "log_frequency": 5,
              "rar_init": True, "rar_pool": RAR_POOL,
              "log_file": os.path.join(WORK_DIR, "rar_stage2.jsonl")}

    _reset_counts()
    r1, s1, (losses1,) = _run_stage("rar", inf_cont_burgers.run, stage1)
    draws = r1["rar_draws"]
    if draws < 3:
        raise AssertionError(f"rar stage 1 made {draws} draws, expected >= 3")
    # One launch per float32 draw, one for f_pred.
    _expect_counts("rar stage 1", {"burgers_residual": draws + 1})
    launches = _read_counts(["burgers_residual"])
    adam_rate, lbfgs_rate = _rates(r1["timing"], stage1["tf_epochs"])
    log(f"[rar] stage 1: {draws} draws of {RAR_POOL} candidates, launches "
        f"{launches}; rel-L2 {r1['error']:.6e}, {s1:.2f} s, Adam "
        f"{adam_rate:.2f} steps/s, L-BFGS {lbfgs_rate:.2f} iters/s "
        f"({r1['timing']['lbfgs_iters']} iterations)")

    rc, sc, (losses_c,) = _run_stage("rar control", inf_cont_burgers.run,
                                     control)
    after = {"burgers_residual": draws + 2}   # + the control's f_pred
    _expect_counts("rar control", after)
    adam_c, lbfgs_c = _rates(rc["timing"], control["tf_epochs"])
    log(f"[rar] control without RAR: rel-L2 {rc['error']:.6e}, {sc:.2f} s, "
        f"Adam {adam_c:.2f} steps/s, L-BFGS {lbfgs_c:.2f} iters/s "
        f"({rc['timing']['lbfgs_iters']} iterations)")

    r2, s2, (losses2,) = _run_stage("rar stage 2", inf_cont_burgers.run,
                                    stage2)
    if r2["rar_draws"] != 1:
        raise AssertionError(f"rar_init made {r2['rar_draws']} draws")
    _expect_counts("rar stage 2 (float64, eager scoring)", after)
    log(f"[rar] stage 2 (float64, rar_init): rel-L2 {r2['error']:.6e}, "
        f"{s2:.2f} s; residual-kernel launches unchanged")

    # The top-k set of one pool, from the kernel and from the plain
    # version: only near-ties at the k-th value may swap.
    data = r1["data"]
    cand = data.lb + (data.ub - data.lb) * lhs(2, RAR_POOL,
                                               np.random.RandomState(77))
    X = torch.as_tensor(cand, dtype=torch.float32, device="cuda")
    k = stage1["N_f"] // 2
    tops = []
    for fn in (rs.burgers_residual, rs.burgers_residual_plain):
        f = np.abs(fn(r1["params"], X, data.lb, data.ub, NU).cpu().numpy())[:, 0]
        tops.append(set(np.argsort(-f)[:k].tolist()))
    sym = len(tops[0] ^ tops[1])
    log(f"[rar] top-{k} of {RAR_POOL}: kernel vs plain symmetric "
        f"difference {sym} ({sym / k:.2e} of k; bar 1e-3)")
    if sym > 1e-3 * k:
        raise AssertionError(f"top-k sets differ in {sym} points")
    _check_finite([r1["error"], r2["error"], rc["error"], adam_rate,
                   lbfgs_rate, adam_c, lbfgs_c,
                   *[l for _, _, l in losses1 + losses2 + losses_c],
                   *_param_maxes(r1["params"]), *_param_maxes(r2["params"])])
    return launches


def phase_facade_main_path() -> dict:
    """4h: the facade, a user's subclass on the v1 fused SSE."""
    import torch
    from pinn_torch import export as pexport
    from pinn_torch.api import PhysicsInformedNN
    from pinn_torch.data import burgers_cont_inference
    from pinn_torch.ops import fused_train as ft
    from pinn_torch.params import leaves
    from pinn_torch.utils import Logger

    np.random.seed(1234)
    data = burgers_cont_inference(100, 10000)

    class V1BurgersPINN(PhysicsInformedNN):
        """mse(u - u_pred) + SSE(f) / N_f, the SSE on the v1 kernels."""

        def __init__(self, hp, logger):
            super().__init__(hp, logger, data.ub, data.lb,
                             dtype=torch.float32, seed=1234, device="cuda")
            self.X_f = self.tensor(data.X_f)
            self.sse = ft.make_burgers_sse(data.lb, data.ub, NU)
            self.grad_evals = 0

        def extra_batch(self):
            return {"X_f": self.X_f}

        def loss(self, params, batch):
            if torch.is_grad_enabled() and any(a.requires_grad
                                               for a in leaves(params)):
                self.grad_evals += 1
            u_pred = self.apply(params, batch["X_u"])
            return (torch.mean(torch.square(batch["u"] - u_pred))
                    + self.sse(params, batch["X_f"]) / batch["X_f"].shape[0])

    hp = {"layers": FLAGSHIP, "tf_epochs": 100, "tf_lr": 0.03, "tf_b1": 0.9,
          "tf_eps": None, "nt_epochs": 100, "nt_lr": 0.8, "nt_ncorr": 50,
          "nt_line_search": "wolfe", "nt_vector_dtype": "float64",
          "log_frequency": 25,
          "log_file": os.path.join(WORK_DIR, "facade.jsonl")}
    model = V1BurgersPINN(hp, Logger(hp, device="cuda"))
    batch = {"X_u": model.tensor(data.X_u_train), "u": model.tensor(data.u_train),
             "X_f": model.X_f}
    with torch.no_grad():   # both are mse_u + mse_f at the first iterate
        v1 = float(model.loss(model.params, batch))
        fused = float(ft.make_burgers_loss(data.lb, data.ub, NU)(model.params,
                                                                 batch))
    if not math.isclose(v1, fused, rel_tol=1e-5):
        raise AssertionError(f"facade loss {v1} vs make_burgers_loss {fused}")
    log(f"[facade] first iterate: v1 loss {v1:.7e}, make_burgers_loss "
        f"{fused:.7e}")

    _reset_counts()
    model.grad_evals = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(data.X_u_train, data.u_train)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _expect_counts("facade", {"burgers_sse_grad": model.grad_evals,
                              "burgers_loss_grad": 0, "burgers_loss": 0})
    launches = _read_counts(["burgers_sse_grad", "burgers_sse"])
    if launches["burgers_sse"] < model.grad_evals:
        raise AssertionError(f"facade: {launches} for {model.grad_evals} "
                             "gradient evaluations")
    losses, = _logged_runs(hp["log_file"])
    log(f"[facade] logged losses: {_fmt(losses)}")
    _check_falls("facade", losses)
    u_pred = model.predict(data.X_star)
    err = float(np.linalg.norm(data.u_star - u_pred) / np.linalg.norm(data.u_star))
    adam_rate, lbfgs_rate = _rates(model.trainer.timing, hp["tf_epochs"])
    log(f"[facade] launches {launches} for {model.grad_evals} gradient "
        f"evaluations; rel-L2 {err:.6e}, {seconds:.2f} s, Adam "
        f"{adam_rate:.2f} steps/s, L-BFGS {lbfgs_rate:.2f} iters/s "
        f"({model.trainer.timing['lbfgs_iters']} iterations)")

    path = model.export_serving(os.path.join(WORK_DIR, "facade"))
    served = pexport.load(path)
    u_served = served.predict(data.X_star).cpu().numpy()
    if not np.allclose(u_served, u_pred, rtol=1e-5, atol=1e-6):
        raise AssertionError("the served facade deviates from predict")
    for n in (1, 7):
        out = served(data.X_star[:n])
        if tuple(out.shape) != (n, 1) or out.device.type != "cuda":
            raise AssertionError(f"served batch {n}: {tuple(out.shape)} on "
                                 f"{out.device}")
    log(f"[facade] export_serving: {os.path.basename(path)}, "
        f"{os.path.getsize(path)} bytes, served = predict on the grid, "
        f"batches 1 and 7 served on the card")
    _check_finite([err, adam_rate, lbfgs_rate, *[l for _, _, l in losses],
                   *_param_maxes(model.params)])
    return launches


def phase_serving_main_path() -> dict:
    """4i: the serving example at the flagship width."""
    from pinn_torch.experiments import serving_example

    members = 2
    hp = {"device": "cuda", "members": members, "layers": FLAGSHIP,
          "N_u": 100, "N_f": 10000, "fused_residual": True,
          "nt_vector_dtype": "float64", "tf_epochs": 100, "nt_epochs": 100,
          "log_frequency": 50,
          "artifact": os.path.join(WORK_DIR, "serving.pt2"),
          "log_file": os.path.join(WORK_DIR, "serving.jsonl")}
    _reset_counts()
    r, seconds, runs = _run_stage("serving", serving_example.run, hp)
    # Per member: f_pred at the end of its run, and its scoring.
    _expect_counts("serving", {"burgers_residual": 2 * members})
    launches = _read_counts(["burgers_residual"])
    w = r["weights"]
    if not (len(runs) == members and math.isclose(float(np.sum(w)), 1.0,
                                                  rel_tol=1e-12)):
        raise AssertionError(f"serving: {len(runs)} member runs, weights {w}")
    log(f"[serving] {seconds:.2f} s; member rel-L2 {r['member_errors']}, "
        f"validation metrics {r['vals']}, weights {w.tolist()}, served "
        f"ensemble rel-L2 {r['error']:.6e}, artifact {r['bytes']} bytes; "
        f"launches {launches}")
    _check_finite([r["error"], *r["member_errors"], *r["vals"], *w.tolist()])
    return launches


def phase_residual_diagnostics() -> dict:
    """4j: the features-major Burgers residual and the Schrödinger
    residual on their grids under the nets of 4 and 4c, against the
    eager residuals (mean squared residual within 1%: after training
    f is a small difference of large terms, so pointwise relative bars
    do not apply)."""
    import torch
    from pinn_torch.ops import residual as rs
    from pinn_torch.problems import burgers, schrodinger

    values = []
    _reset_counts()
    X, lb, ub = _grid("burgers")
    X = torch.as_tensor(X, device="cuda")
    f = rs.burgers_residual_fmajor(TRAINED["burgers"], X, lb, ub, NU)
    fs = [f]
    lb_t, ub_t = torch.as_tensor(lb, device="cuda"), torch.as_tensor(ub, device="cuda")
    with torch.no_grad():
        f_eager = [burgers.residual_cont(TRAINED["burgers"], X, lb_t, ub_t, nu=NU)]
    Xs, slb, sub = _grid("schrodinger")
    Xs = torch.as_tensor(Xs, device="cuda")
    fs += rs.schrodinger_residual(TRAINED["schrodinger"], Xs, slb, sub)
    slb_t, sub_t = (torch.as_tensor(a, device="cuda") for a in (slb, sub))
    with torch.no_grad():
        f_eager += schrodinger.residual(TRAINED["schrodinger"], Xs, slb_t, sub_t)
    launches = _read_counts(["burgers_residual_fmajor", "schrodinger_residual"])
    for name, got, want in zip(("burgers f", "schrodinger f_u",
                                "schrodinger f_v"), fs, f_eager):
        m_got = float(torch.mean(torch.square(got)))
        m_want = float(torch.mean(torch.square(want)))
        log(f"[diagnostics] {name} on the grid ({got.shape[0]} points): mean "
            f"f^2 {m_got:.6e} (eager {m_want:.6e})")
        if not math.isclose(m_got, m_want, rel_tol=1e-2):
            raise AssertionError(f"{name}: kernel {m_got} vs eager {m_want}")
        values += [m_got, m_want]
    _check_finite(values)
    log(f"[diagnostics] launches {launches}")
    return launches


def _disc_stages(tag, run, stages, layers):
    """Run one eager family's stages in order at full width (the
    discrete-time IRK families, Navier–Stokes: these paths launch no
    hand-written kernel, so every count stays 0); each stage's
    parameters on the card, its logged losses falling and every value
    finite.  ``layers`` is the full width the run must have taken (the
    output width set to q).  Prints the error (rel-L2, or the lambda
    pairs and the mean relative lambda error, and the field errors
    where the run has them), the stage's wall-clock and its Adam and
    L-BFGS rates.  Returns the results."""
    from pinn_torch.params import leaves

    _reset_counts()
    values, results = [], []
    for i, hp in enumerate(stages, 1):
        r, seconds, runs = _run_stage(f"{tag} stage {i}", run, hp)
        if r["hp"]["layers"] != layers:
            raise AssertionError(f"{tag}: layers {r['hp']['layers']}, "
                                 f"expected {layers}")
        nets = [r["params"]] + ([r["params_noisy"]] if "params_noisy" in r else [])
        if not all(a.is_cuda for net in nets for a in leaves(net)):
            raise AssertionError(f"{tag} stage {i}: a parameter left the card")
        if "lambdas" in r:
            err = (f"lambda1 {r['lambdas'][0]:.6f}, lambda2 "
                   f"{r['lambdas'][1]:.6e}; noisy lambda1 "
                   f"{r['lambdas_noisy'][0]:.6f}, lambda2 "
                   f"{r['lambdas_noisy'][1]:.6e}; mean relative lambda "
                   f"error {r['error']:.6e}")
            values += [*r["lambdas"], *r["lambdas_noisy"]]
        else:
            err = f"rel-L2 {r['error']:.6e}"
        if "field_errors" in r:
            fe = r["field_errors"]
            err += (f"; rel-L2 on the {r['data'].X_star.shape[0]:,}-point "
                    f"grid: u {fe['u']:.6e}, v {fe['v']:.6e}, p "
                    f"(gauge-adjusted) {fe['p']:.6e}")
            values += [fe["u"], fe["v"], fe["p"]]
        values += [float(np.max(np.abs(r[key])))
                   for key in ("U_0_pred", "U_1_pred", "u_1_pred") if key in r]
        timing = r["timing"]
        cases = timing if "clean" in timing else {"": timing}
        rates = []
        for case, t in cases.items():
            adam = hp["tf_epochs"] / t["adam_s"] if hp["tf_epochs"] else None
            lbfgs = t["lbfgs_iters"] / t["lbfgs_s"]
            rates.append(f"{case + ': ' if case else ''}"
                         + (f"Adam {adam:.2f} steps/s ({1e3 / adam:.3f} ms), "
                            if adam else "")
                         + f"L-BFGS {lbfgs:.2f} iters/s ({1e3 / lbfgs:.3f} ms, "
                         f"{t['lbfgs_iters']} iterations)")
            values += [lbfgs] + ([adam] if adam else [])
        name = f"[{tag}] stage {i} ({hp.get('dtype', 'float32')})"
        log(f"{name} error: {err}")
        log(f"{name} wall-clock: {seconds:.2f} s")
        log(f"{name} rates: " + "; ".join(rates))
        values += [r["error"], seconds, *[l for run_ in runs for _, _, l in run_]]
        for net in nets:
            values += _param_maxes(net)
        results.append(r)
    _expect_counts(tag, {name: 0 for name in _counts()})
    _check_finite(values)
    return results


def _disc_hp(name, two_stages=True):
    """The campaign's stages of a discrete recipe, cut to 100 + 100
    (float32, float64 L-BFGS vectors, matrix direction) and 50 float64
    iterations from the first's checkpoint."""
    ckpt = os.path.join(WORK_DIR, f"{name}_stage1.npz")
    stage1 = {"device": "cuda", "tf_epochs": 100, "nt_epochs": 100,
              "log_frequency": 25, "save_checkpoint": ckpt,
              "log_file": os.path.join(WORK_DIR, f"{name}_stage1.jsonl")}
    if not two_stages:
        return [stage1]
    stage1.update(nt_vector_dtype="float64", nt_dir_impl="matrix")
    stage2 = {"device": "cuda", "dtype": "float64", "net_impl": "df32",
              "nt_dir_impl": "matrix", "init_checkpoint": ckpt,
              "tf_epochs": 0, "nt_epochs": 50, "log_frequency": 10,
              "log_file": os.path.join(WORK_DIR, f"{name}_stage2.jsonl")}
    return [stage1, stage2]


def phase_disc_main_paths() -> dict:
    """4k-4n: the discrete-time IRK families at full width."""
    from pinn_torch.experiments import (ide_disc_burgers, ide_disc_kdv,
                                        inf_disc_allencahn, inf_disc_burgers)
    _disc_stages("4k disc burgers", inf_disc_burgers.run,
                 _disc_hp("disc_burgers"), [1, 50, 50, 50, 501])
    _disc_stages("4l ide disc burgers", ide_disc_burgers.run,
                 _disc_hp("ide_disc_burgers"), [1, 50, 50, 50, 81])
    _disc_stages("4m allen-cahn", inf_disc_allencahn.run,
                 _disc_hp("allencahn"), [1, 200, 200, 200, 200, 101])
    _disc_stages("4n kdv", ide_disc_kdv.run,
                 _disc_hp("kdv", two_stages=False), [1, 50, 50, 50, 50])
    return {}


def phase_navierstokes_main_path() -> dict:
    """4o: Navier–Stokes identification at the campaign's width on the
    spectral DNS's full grid, a float32 stage and a float64 stage with a
    separate collocation set and best-iterate selection."""
    from pinn_torch.experiments import ide_cont_navierstokes

    ckpt = os.path.join(WORK_DIR, "ns_stage1.npz")
    common = {"device": "cuda", "layers": NS_LAYERS, "N_u": 10000,
              "nt_dir_impl": "matrix"}
    stage1 = {**common, "nt_vector_dtype": "float64", "tf_epochs": 100,
              "nt_epochs": 100, "log_frequency": 25, "save_checkpoint": ckpt,
              "log_file": os.path.join(WORK_DIR, "ns_stage1.jsonl")}
    stage2 = {**common, "dtype": "float64", "net_impl": "df32",
              "init_checkpoint": ckpt, "tf_epochs": 0, "nt_epochs": 20,
              "N_f": 20000, "nt_val_every": 10, "log_frequency": 10,
              "log_file": os.path.join(WORK_DIR, "ns_stage2.jsonl")}
    results = _disc_stages("4o navier-stokes", ide_cont_navierstokes.run,
                           [stage1, stage2], NS_LAYERS)
    for i, r in enumerate(results, 1):
        if r["data"].X_star.shape[0] != NS_GRID or r["hp"]["N_u"] != 10000:
            raise AssertionError(
                f"4o stage {i}: grid {r['data'].X_star.shape[0]} points, N_u "
                f"{r['hp']['N_u']}; expected {NS_GRID} and 10000")
    return {}


def _read_traces(trace_dir):
    """Every Chrome trace under ``trace_dir`` (one a ``fit``), read and
    then deleted with the directory.  Returns (launches of each device
    kernel by name, device-busy microseconds, traced wall microseconds),
    summed over the traces; the busy time is the union of the device's
    intervals, the wall window the first event's start to the last
    one's end."""
    import glob
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json")))
    if not paths:
        raise AssertionError(f"no trace written under {trace_dir}")
    names, busy, wall = {}, 0.0, 0.0
    for path in paths:
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
        wall += (max(e["ts"] + e["dur"] for e in events)
                 - min(e["ts"] for e in events))
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in DEVICE_CATEGORIES)
        end = -math.inf
        for a, b in spans:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        for e in events:
            if e.get("cat") == "kernel":
                names[e["name"]] = names.get(e["name"], 0) + 1
    shutil.rmtree(trace_dir)
    return names, busy, wall


def _ours(names, kernel):
    """Launches in a trace of the kernel template named ``kernel``."""
    return sum(n for name, n in names.items() if kernel in name)


def _traced(tag, run, hp, adam_steps=0):
    """``run(hp)`` with ``trace_dir``; prints the busy share of the
    traced window and, for an Adam-only run, its Adam ms a step beside
    the same run's untraced.  Returns (result, kernel launches by name)."""
    trace_dir = os.path.join(WORK_DIR, "trace")
    r = run({**hp, "trace_dir": trace_dir})
    names, busy, wall = _read_traces(trace_dir)
    line = (f"[trace] {tag}: device busy {busy / wall:.1%} of the traced "
            f"window ({busy / 1e3:.2f} of {wall / 1e3:.2f} ms, "
            f"{sum(names.values())} kernel launches)")
    if adam_steps:
        plain = run(hp)
        ms = [t["adam_s"] * 1e3 / adam_steps
              for t in _case_timings(r) + _case_timings(plain)]
        half = len(ms) // 2
        device = busy / 1e3 / (adam_steps * half)
        line += (f"; Adam ms a step traced {', '.join(f'{m:.3f}' for m in ms[:half])}"
                 f", untraced {', '.join(f'{m:.3f}' for m in ms[half:])}; "
                 f"device {device:.3f} ms a step, "
                 f"{device * half / sum(ms[half:]):.1%} of the untraced step")
    else:
        line += "; L-BFGS ms an iteration traced " + ", ".join(
            f"{t['lbfgs_s'] * 1e3 / max(t['lbfgs_iters'], 1):.3f}"
            for t in _case_timings(r))
    log(line)
    _check_finite([busy, wall, r["error"]])
    return r, names


def _case_timings(r):
    """The Trainer timings of a result, one a case."""
    t = r["timing"]
    return [t["clean"], t["noisy"]] if "clean" in t else [t]


def phase_traced_main_paths() -> None:
    """4p: ``trace_dir`` on the flagship, then on 4k and 4o."""
    from pinn_torch.experiments import (ide_cont_navierstokes,
                                        inf_cont_burgers, inf_disc_burgers)

    ckpt = os.path.join(WORK_DIR, "traced.npz")
    # The experiment's Armijo search: its trials launch row 2.
    flagship = {"device": "cuda", "layers": FLAGSHIP, "N_u": 100,
                "N_f": 10000, "fused_residual": True,
                "nt_vector_dtype": "float64", "log_frequency": 10,
                "save_checkpoint": ckpt}
    _reset_counts()
    _, names = _traced("4p flagship, 50 Adam + 20 L-BFGS",
                       inf_cont_burgers.run,
                       {**flagship, "tf_epochs": 50, "nt_epochs": 20})
    counts = _counts()
    # inf_cont_burgers.run's closing loss (one burgers_loss launch)
    # falls after fit, outside the trace.
    want = {"pt_narrow_loss_grad_kernel": counts["burgers_loss_grad"],
            "pt_narrow_loss_kernel": counts["burgers_loss"] - 1}
    got = {kernel: _ours(names, kernel) for kernel in want}
    log(f"[trace] 4p launches in the trace {got}; counters {counts}")
    if got != want or not all(got.values()):
        raise AssertionError(f"4p: trace launches {got}, counters give {want}")

    stages = (("4p flagship", inf_cont_burgers.run,
               {k: v for k, v in flagship.items() if k != "save_checkpoint"},
               50, 20, {"init_checkpoint": ckpt}),
              ("4k disc burgers", inf_disc_burgers.run,
               {"device": "cuda", "nt_vector_dtype": "float64",
                "nt_dir_impl": "matrix", "log_frequency": 10}, 20, 10, {}),
              ("4o navier-stokes", ide_cont_navierstokes.run,
               {"device": "cuda", "layers": NS_LAYERS, "N_u": 10000,
                "nt_vector_dtype": "float64", "nt_dir_impl": "matrix",
                "log_frequency": 10}, 3, 2, {}))
    for tag, run, hp, adam, lbfgs, warm in stages:
        _reset_counts()
        _, adam_names = _traced(f"{tag} Adam ({adam} steps)", run,
                                {**hp, "tf_epochs": adam, "nt_epochs": 0},
                                adam_steps=adam)
        _, lbfgs_names = _traced(f"{tag} L-BFGS ({lbfgs} iterations)", run,
                                 {**hp, **warm, "tf_epochs": 0,
                                  "nt_epochs": lbfgs})
        if tag.startswith("4p"):
            continue
        ours = {k: _ours({**adam_names, **lbfgs_names}, k)
                for k in ("pt_narrow", "pt_tile", "pt_reduce")}
        if any(ours.values()):
            raise AssertionError(f"{tag}: our kernels in the trace: {ours}")
        _expect_counts(tag, {name: 0 for name in _counts()})


def phase_custom_pde() -> None:
    """4q: the heat equation on the facade, 100 + 300."""
    from pinn_torch.experiments import custom_pde_example
    from pinn_torch.params import leaves

    r, seconds, _ = _run_stage(
        "4q custom pde", custom_pde_example.run,
        {"device": "cuda", "tf_epochs": 100, "nt_epochs": 300,
         "log_frequency": 100,
         "log_file": os.path.join(WORK_DIR, "custom_pde.jsonl")})
    if not all(a.is_cuda for a in leaves(r["pinn"].params)):
        raise AssertionError("4q: a parameter left the card")
    log(f"[4q custom pde] rel-L2 {r['error']:.6e} (bar 7e-3), "
        f"{seconds:.2f} s")
    _check_finite([r["error"], seconds])
    if not r["error"] < 7e-3:
        raise AssertionError(f"4q: rel-L2 {r['error']} not under 7e-3")


def phase_campaign_f32() -> None:
    """4r: the flagship recipe's quick campaign in float32."""
    from pinn_torch.experiments import run_campaign

    out = os.path.join(WORK_DIR, "campaign_f32.json")
    rc = run_campaign.main(["inf_cont_burgers", "--quick", "--f32",
                            "--out", out])
    with open(out) as fh:
        row, = json.load(fh)
    dtypes = [s["dtype"] for s in row["stages"]]
    errors = [s["error"] for s in row["stages"]]
    log(f"[4r campaign --f32] exit {rc}; stages {dtypes}, errors "
        f"{', '.join(f'{e:.6e}' for e in errors)}, {row['seconds']:.2f} s")
    _check_finite(errors)
    if rc != 0 or dtypes != ["float32"] * len(
            run_campaign.CAMPAIGN["inf_cont_burgers"]):
        raise AssertionError(f"4r: exit {rc}, stage dtypes {dtypes}")


def phase_bench_measure() -> None:
    """4s: inf_cont_burgers_bench's measuring part at --quick."""
    from pinn_torch.experiments import inf_cont_burgers_bench as bench

    res = bench.measure(quick=True, device="cuda")
    values = [res["pinn_error"], res["pinn_seconds"]]
    for key in ("domain", "boundary"):
        values += res[key]["errors"] + res[key]["seconds"]
        log(f"[4s bench] plain NN, {key} data: N_u {res[key]['N_u']}, "
            f"rel-L2 {', '.join(f'{e:.4e}' for e in res[key]['errors'])}, "
            f"s {', '.join(f'{t:.2f}' for t in res[key]['seconds'])}")
    log(f"[4s bench] PINN rel-L2 {res['pinn_error']:.4e} in "
        f"{res['pinn_seconds']:.2f} s")
    _check_finite(values)


def _dp_value_and_grad(loss_fn, params, batch):
    """(loss, gradients) of ``loss_fn`` at ``params``, detached (zeros
    for a leaf the loss does not use, as NS's last bias)."""
    import torch
    from pinn_torch.params import leaves, rebuild
    live = [a.detach().clone().requires_grad_(True) for a in leaves(params)]
    val = loss_fn(rebuild(params, live), batch)
    grads = torch.autograd.grad(val, live, allow_unused=True)
    return val.detach(), [torch.zeros_like(a) if g is None else g
                          for a, g in zip(live, grads)]


def _adam_ms(loss_fn, params, batch, steps=30):
    """Host ms an Adam step (zero_grad, loss, backward, step), as the
    Trainer takes it, after a device sync on each side."""
    import torch
    from pinn_torch.params import leaves, rebuild
    live = [a.detach().clone().requires_grad_(True) for a in leaves(params)]
    p = rebuild(params, live)
    opt = torch.optim.Adam(live, lr=1e-3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss_fn(p, batch).backward()
        opt.step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def _dp_case(tag, whole, dp, dp1, params, batch, grad_name, loss_name):
    """4t (a): ``dp`` (four shards on one card) against ``whole`` (one
    launch): the loss to rtol 1e-6, the gradients to rtol 2e-5 / atol
    1e-7; ``grad_name`` counts exactly 4 a call with gradients and
    ``loss_name`` 4 a call without; two calls bitwise equal.  Then the
    Adam step's ms on ``whole``, ``dp1`` (one shard) and ``dp``, in
    turns."""
    import torch
    val, grads = _dp_value_and_grad(whole, params, batch)
    _reset_counts()
    got, got_g = _dp_value_and_grad(dp, params, batch)
    _expect_counts(f"4t {tag} DP call", {grad_name: 4, loss_name: 0})
    again, again_g = _dp_value_and_grad(dp, params, batch)
    with torch.no_grad():
        nograd = dp(params, batch)
    _expect_counts(f"4t {tag} DP calls", {grad_name: 8, loss_name: 4})
    if not (torch.equal(got, again)
            and all(torch.equal(a, b) for a, b in zip(got_g, again_g))):
        raise AssertionError(f"4t {tag}: two DP calls differ")
    np.testing.assert_allclose(float(got), float(val), rtol=1e-6,
                               err_msg=f"4t {tag} loss")
    errs = []
    for a, b in zip(got_g, grads):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-7,
                                   err_msg=f"4t {tag} gradients")
        errs.append(float(np.max(np.abs(a - b))))
    log(f"[4t {tag}] 4 shards on one card: loss {float(got):.9e} (one launch "
        f"{float(val):.9e}, loss-only {float(nograd):.9e}), max |dgrad| "
        f"{max(errs):.3e}; two calls bitwise equal")
    ms = {"whole": [], "1 shard": [], "4 shards": []}
    for name, fn in [("whole", whole), ("4 shards", dp), ("1 shard", dp1)] * 2:
        ms[name].append(_adam_ms(fn, params, batch))
    log(f"[4t {tag}] Adam ms a step (host clock, 30 steps, two turns): "
        + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                    for k, v in ms.items()))
    _check_finite([float(got), float(nograd), *[t for v in ms.values()
                                                for t in v]])


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_data_parallel() -> None:
    """4t: the data-parallel tier: (a) four shards of rows 1 and 7 on
    the card against one launch, (b) a world-size-1 NCCL mesh against
    the in-process one-shard step, (c) both experiments with tpu_mesh."""
    import torch
    import torch.distributed as dist
    from pinn_torch.experiments import inf_cont_burgers, inf_cont_schrodinger
    from pinn_torch.ops import fused_schrodinger as fs
    from pinn_torch.ops import fused_train as ft
    from pinn_torch.parallel import distributed as pdist
    from pinn_torch.parallel import make_mesh
    from pinn_torch.params import ravel

    dev = torch.device("cuda", 0)
    mesh1, mesh4 = make_mesh(devices=[dev]), make_mesh(devices=[dev] * 4)

    def cuda(arrays):
        return {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in arrays.items()}

    # (a) Burgers at the flagship, Schrödinger at [2, 100x4, 2].
    rng = np.random.RandomState(17)
    params = _weights(FLAGSHIP, rng)
    batch = cuda({"X_u": LB + (UB - LB) * rng.rand(100, 2),
                  "u": rng.rand(100, 1),
                  "X_f": LB + (UB - LB) * rng.rand(10000, 2)})
    _dp_case("burgers", ft.make_burgers_loss(LB, UB, NU),
             ft.make_burgers_loss_dp(LB, UB, NU, mesh4),
             ft.make_burgers_loss_dp(LB, UB, NU, mesh1), params, batch,
             "burgers_loss_grad", "burgers_loss")
    s_params = _weights(S_FLAGSHIP, rng)
    x0 = S_LB[0] + (S_UB[0] - S_LB[0]) * rng.rand(50, 1)
    tb = rng.rand(50, 1) * S_UB[1]
    s_batch = cuda({"X0": np.hstack([x0, 0 * x0]), "H0": rng.randn(50, 2),
                    "X_lb": np.hstack([0 * tb + S_LB[0], tb]),
                    "X_ub": np.hstack([0 * tb + S_UB[0], tb]),
                    "X_f": S_LB + (S_UB - S_LB) * rng.rand(20000, 2)})
    _dp_case("schrodinger", fs.make_schrodinger_loss(S_LB, S_UB),
             fs.make_schrodinger_loss_dp(S_LB, S_UB, mesh4),
             fs.make_schrodinger_loss_dp(S_LB, S_UB, mesh1), s_params,
             s_batch, "schrodinger_sse_grad", "schrodinger_sse")

    # (b) World size 1 on NCCL: one Adam step of the fused flagship loss,
    # bitwise the in-process one-shard step.
    from pinn_torch.graft_entry import adam_step
    want = adam_step(ft.make_burgers_loss_dp(LB, UB, NU, mesh1), params, batch)
    t0 = time.perf_counter()
    pdist.init_distributed(f"localhost:{_free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"4t: backend {dist.get_backend()}, not nccl")
        mesh = pdist.make_multihost_mesh()
        got = adam_step(ft.make_burgers_loss_dp(LB, UB, NU, mesh), params,
                        batch)
    finally:
        dist.destroy_process_group()
    if not (got[0] == want[0] and torch.equal(got[1], want[1])
            and torch.equal(ravel(got[2]), ravel(want[2]))):
        raise AssertionError("4t: the NCCL world-size-1 step differs from "
                             "the in-process one")
    log(f"[4t nccl] world size 1, mesh {mesh.shape}: loss {got[0]:.9e}, "
        f"gradients and parameters bitwise the in-process step "
        f"({time.perf_counter() - t0:.2f} s with the group's set-up)")

    # (c) The two experiments with tpu_mesh: true (one shard on a
    # one-card machine) beside the unsharded run, cut to 50 + 50.
    cases = [("burgers", inf_cont_burgers, {}, _check_falls,
              "burgers_loss_grad", "burgers_loss"),
             # A gentler Adam than the recipe's spike (see 4f).
             ("schrodinger", inf_cont_schrodinger,
              {"tf_lr": 0.005, "tf_b1": 0.9}, _check_final_falls,
              "schrodinger_sse_grad", "schrodinger_sse")]
    for tag, mod, extra, check, grad_name, loss_name in cases:
        seen = {}
        for mesh_key in (True, None):
            name = "mesh" if mesh_key else "unsharded"
            hp = {"device": "cuda", "fused_residual": True, "tf_epochs": 50,
                  "nt_epochs": 50, "log_frequency": 10, **extra,
                  "log_file": os.path.join(WORK_DIR, f"4t_{tag}_{name}.jsonl")}
            if mesh_key:
                hp["tpu_mesh"] = True
            _reset_counts()
            r, s, (losses,) = _run_stage(f"4t {tag} {name}", mod.run, hp,
                                         check=check)
            counts = _read_counts([grad_name, loss_name])
            # Each Adam step, each L-BFGS evaluation and the closing loss
            # launch row 1 (7) or row 2 (8) once.
            want_n = hp["tf_epochs"] + r["timing"]["lbfgs_evals"] + 1
            if sum(counts.values()) != want_n or \
                    counts[grad_name] < hp["tf_epochs"]:
                raise AssertionError(f"4t {tag} {name}: launches {counts}, "
                                     f"expected {want_n} in all")
            adam_rate, lbfgs_rate = _rates(r["timing"], hp["tf_epochs"])
            log(f"[4t {tag}] {name}: launches {counts}, rel-L2 "
                f"{r['error']:.6e}, {s:.2f} s, Adam {adam_rate:.2f} steps/s, "
                f"L-BFGS {lbfgs_rate:.2f} iters/s "
                f"({r['timing']['lbfgs_iters']} iterations)")
            _check_finite([r["error"], r["loss"], adam_rate, lbfgs_rate])
            seen[name] = (counts, [l for _, _, l in losses], r["loss"])
        if seen["mesh"] != seen["unsharded"]:
            raise AssertionError(f"4t {tag}: the one-shard mesh run differs "
                                 f"from the unsharded run: {seen}")
        log(f"[4t {tag}] one-shard mesh run: counts and logged losses "
            f"bitwise the unsharded run's")


def _tp_cases(rng):
    """4u (a): (tag, layers, loss, params, batch, shard keys, scale) at
    full width on the card; the loss is a mean over the shard keys' rows
    (KdV's is a sum over both snapshots: each data shard's loss is
    scaled by the shard count, 2, which is exact)."""
    import torch
    from pinn_torch import irk
    from pinn_torch.problems import burgers, kdv, navierstokes, schrodinger

    dev = torch.device("cuda", 0)

    def cuda(arrays):
        return {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in arrays.items()}

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    lb, ub, s_lb, s_ub = const(LB), const(UB), const(S_LB), const(S_UB)
    cases = []
    b = cuda({"X_u": LB + (UB - LB) * rng.rand(100, 2), "u": rng.rand(100, 1),
              "X_f": LB + (UB - LB) * rng.rand(10000, 2)})
    cases.append(("burgers", FLAGSHIP,
                  lambda p, b: burgers.loss_cont_inference(
                      p, b["X_u"], b["u"], b["X_f"], lb, ub, NU),
                  _weights(FLAGSHIP, rng), b, ("X_u", "u", "X_f"), 1))
    x0 = S_LB[0] + (S_UB[0] - S_LB[0]) * rng.rand(50, 1)
    tb = rng.rand(50, 1) * S_UB[1]
    b = cuda({"X0": np.hstack([x0, 0 * x0]), "H0": rng.randn(50, 2),
              "X_lb": np.hstack([0 * tb + S_LB[0], tb]),
              "X_ub": np.hstack([0 * tb + S_UB[0], tb]),
              "X_f": S_LB + (S_UB - S_LB) * rng.rand(20000, 2)})
    cases.append(("schrodinger", S_FLAGSHIP, lambda p, b: schrodinger.loss(
        p, b["X0"], b["H0"], b["X_lb"], b["X_ub"], b["X_f"], s_lb, s_ub),
        _weights(S_FLAGSHIP, rng), b, ("X_f",), 1))
    ns_lb, ns_ub = np.array([1.0, -2.0, 0.0]), np.array([8.0, 2.0, 20.0])
    b = cuda({"X": ns_lb + (ns_ub - ns_lb) * rng.rand(10000, 3),
              "u": rng.randn(10000, 1), "v": rng.randn(10000, 1)})
    n_lb, n_ub = const(ns_lb), const(ns_ub)
    net = _weights(NS_LAYERS, rng)
    cases.append(("navier-stokes", NS_LAYERS,
                  lambda p, b: navierstokes.loss_identification(
                      p, b["X"], b["u"], b["v"], n_lb, n_ub),
                  navierstokes.NSIdeParams(net, const([0.9]), const([0.01])),
                  b, ("X", "u", "v"), 1))
    q = 50
    w = irk.irk_weights(q)[0].astype(np.float32)
    alpha, beta = const(w[:-1]), const(w[-1:])
    k_lb, k_ub = const([-1.0]), const([1.0])
    b = cuda({"x_0": -1 + 2 * rng.rand(200, 1), "u_0": rng.randn(200, q),
              "x_1": -1 + 2 * rng.rand(200, 1), "u_1": rng.randn(200, q)})
    layers = [1, 50, 50, 50, q]
    cases.append(("kdv", layers, lambda p, b: kdv.loss_disc_identification(
        p, b["x_0"], b["u_0"], b["x_1"], b["u_1"], k_lb, k_ub, 0.6, alpha,
        beta), burgers.IdeParams(_weights(layers, rng), const([0.9]),
                                 const([np.log(0.002)])), b,
        ("x_0", "u_0", "x_1", "u_1"), 2))
    return cases


def _tp_place(params, mesh):
    """``params`` with its net placed by ``shard_params_tp``."""
    from pinn_torch.parallel import shard_params_tp
    if hasattr(params, "_fields"):
        return params._replace(net=shard_params_tp(params.net, mesh))
    return shard_params_tp(params, mesh)


def phase_tensor_parallel() -> None:
    """4u: tensor parallelism on a (2, 2) mesh of cuda:0: (a) TP+DP loss
    and gradients at full width against the unsharded loss, (b) a
    Trainer run on TP parameters beside the unsharded run, (c) the
    flagship with ``dtype: "bfloat16"``, (d) the dry run with its TP+DP
    leg.  No kernel of ours may launch."""
    import torch
    from pinn_torch import graft_entry
    from pinn_torch.experiments import inf_cont_burgers
    from pinn_torch.params import leaves
    from pinn_torch.parallel import data_parallel, make_mesh_2d
    from pinn_torch.train import Trainer

    dev = torch.device("cuda", 0)
    mesh = make_mesh_2d(2, 2, devices=[dev] * 4)
    _reset_counts()
    rng = np.random.RandomState(18)
    for tag, layers, loss, params, batch, keys, scale in _tp_cases(rng):
        local = loss if scale == 1 else (lambda p, b, f=loss: scale * f(p, b))
        dp = data_parallel(local, mesh, keys)
        tp = _tp_place(params, mesh)
        kinds = [tp_net.kind(l) for tp_net in [getattr(tp, "net", tp)]
                 for l in range(len(layers) - 1)]
        val, grads = _dp_value_and_grad(loss, params, batch)
        got, got_g = _dp_value_and_grad(dp, tp, batch)
        again, again_g = _dp_value_and_grad(dp, tp, batch)
        if not (torch.equal(got, again)
                and all(torch.equal(a, b) for a, b in zip(got_g, again_g))):
            raise AssertionError(f"4u {tag}: two TP+DP calls differ")
        np.testing.assert_allclose(float(got), float(val), rtol=1e-6,
                                   err_msg=f"4u {tag} loss")
        # The sharded bars (tests/test_parallel.py), the gradients' atol
        # taken relative to their largest element: KdV's reach ~50.
        gmax = max(1.0, max(float(g.abs().max()) for g in grads))
        errs = []
        for a, b in zip(got_g, grads):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-7 * gmax,
                                       err_msg=f"4u {tag} gradients")
            errs.append(float(np.max(np.abs(a - b))))
        ms = {"unsharded": [], "TP+DP 2x2": []}
        for name, fn, p in [("unsharded", loss, params),
                            ("TP+DP 2x2", dp, tp)] * 2:
            ms[name].append(_adam_ms(fn, p, batch, steps=10))
        log(f"[4u {tag}] {layers}: layer kinds {kinds}; TP+DP loss "
            f"{float(got):.9e} (unsharded {float(val):.9e}), max |dgrad| "
            f"{max(errs):.3e} (max |grad| {gmax:.3e}); two calls bitwise "
            f"equal; Adam ms a step "
            f"(host clock, 10 steps, two turns): "
            + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                        for k, v in ms.items()))
        _check_finite([float(got), *[t for v in ms.values() for t in v]])

    # (b) The Trainer on TP parameters, Adam 50 + L-BFGS 20, beside the
    # unsharded run from the same weights and points.
    tag, layers, loss, params, batch, keys, _ = _tp_cases(
        np.random.RandomState(19))[0]
    hp = {"tf_epochs": 50, "tf_lr": 1e-3, "nt_epochs": 20,
          "nt_line_search": "armijo", "log_frequency": 10}
    with torch.no_grad():
        first = float(loss(params, batch))
    runs = {}
    for name, fn, p in [("unsharded", loss, params),
                        ("TP+DP 2x2", data_parallel(loss, mesh, keys),
                         _tp_place(params, mesh))]:
        trainer = Trainer(fn, p, batch, hp, mesh=mesh if name != "unsharded"
                          else None)
        out = trainer.fit()
        with torch.no_grad():
            final = float(loss(out, batch))
        t = trainer.timing
        runs[name] = (final, out)
        log(f"[4u trainer] {name}: final loss {final:.6e} (first "
            f"{first:.6e}), Adam "
            f"{1e3 * t['adam_s'] / hp['tf_epochs']:.3f} ms a step, L-BFGS "
            f"{1e3 * t['lbfgs_s'] / max(t['lbfgs_iters'], 1):.3f} ms an "
            f"iteration ({t['lbfgs_iters']} iterations)")
        _check_finite([final, t["adam_s"], t["lbfgs_s"]])
    (f0, p0), (f1, p1) = runs["unsharded"], runs["TP+DP 2x2"]
    diff = max(float((a - b).abs().max()) for a, b in zip(leaves(p0),
                                                          leaves(p1)))
    log(f"[4u trainer] max |dparam| TP+DP against unsharded {diff:.3e}")
    if not (f1 < first and abs(f1 - f0) <= 5e-2 * f0):
        raise AssertionError(f"4u trainer: TP+DP final loss {f1} against "
                             f"unsharded {f0}")

    # (c) The flagship in bfloat16 end to end, 50 + 50.
    hp = {"device": "cuda", "dtype": "bfloat16", "tf_epochs": 50,
          "nt_epochs": 50, "log_frequency": 10,
          "log_file": os.path.join(WORK_DIR, "4u_bf16.jsonl")}
    r, s, _ = _run_stage("4u bf16", inf_cont_burgers.run, hp)
    dtypes = {str(a.dtype) for a in leaves(r["params"])}
    adam_rate, lbfgs_rate = _rates(r["timing"], hp["tf_epochs"])
    log(f"[4u bf16] inf_cont_burgers dtype bfloat16 at {FLAGSHIP}: rel-L2 "
        f"{r['error']:.6e}, {s:.2f} s, Adam {adam_rate:.2f} steps/s, L-BFGS "
        f"{lbfgs_rate:.2f} iters/s ({r['timing']['lbfgs_iters']} "
        f"iterations), parameters {dtypes}")
    if dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"4u bf16: parameters in {dtypes}")
    _check_finite([r["error"], adam_rate])
    _expect_counts("4u (a)-(c)", {name: 0 for name in _counts()})

    # (d) The dry run: eager DP, fused DP, TP+DP (2x2) and two processes.
    _reset_counts()
    graft_entry.dryrun_multichip(4, "cuda")
    # Leg 2 (fused DP) launches rows 1 and 2; the rest of 4u none.
    counts = {k: v for k, v in _counts().items() if v}
    if set(counts) - {"burgers_loss_grad", "burgers_loss"}:
        raise AssertionError(f"4u dry run: launches {counts}")
    log(f"[4u dryrun] dryrun_multichip(4, 'cuda') OK; launches {counts} "
        f"(leg 2, fused DP)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # The port itself, before anything is printed: a copy of this script
    # without the repository stops here.
    import pinn_torch.api  # noqa: F401
    import pinn_torch.experiments.ide_cont_burgers  # noqa: F401
    import pinn_torch.experiments.inf_cont_burgers  # noqa: F401
    import pinn_torch.experiments.inf_cont_schrodinger  # noqa: F401
    import pinn_torch.experiments.serving_example  # noqa: F401
    import pinn_torch.experiments.ide_cont_navierstokes  # noqa: F401
    import pinn_torch.experiments.ide_disc_burgers  # noqa: F401
    import pinn_torch.experiments.ide_disc_kdv  # noqa: F401
    import pinn_torch.experiments.inf_disc_allencahn  # noqa: F401
    import pinn_torch.experiments.inf_disc_burgers  # noqa: F401
    import pinn_torch.experiments.custom_pde_example  # noqa: F401
    import pinn_torch.experiments.inf_cont_burgers_bench  # noqa: F401
    import pinn_torch.experiments.run_campaign  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)

    smi = phase_card()
    phase_build()
    stats = {}
    t0 = time.perf_counter()
    phase_kernels(stats)
    phase_ide_kernels(stats)
    phase_schrodinger_kernels(stats)
    phase_bf16_kernels(stats)
    phase_v1_kernels(stats)
    t1 = time.perf_counter()
    launches = {**phase_main_path(), **phase_ide_main_path(),
                **phase_schrodinger_main_path(), **phase_bf16_main_path(),
                **phase_ide_bf16_main_path(),
                **phase_schrodinger_bf16_main_path(),
                **phase_rar_main_path(), **phase_facade_main_path(),
                **phase_serving_main_path(), **phase_residual_diagnostics()}
    t2 = time.perf_counter()
    phase_disc_main_paths()
    t3 = time.perf_counter()
    log(f"[time] kernel checks {t1 - t0:.1f} s, main paths "
        f"{t2 - t1:.1f} s, discrete families (4k-4n) {t3 - t2:.1f} s")
    phase_navierstokes_main_path()
    t4 = time.perf_counter()
    log(f"[time] Navier-Stokes (4o) {t4 - t3:.1f} s")
    phase_traced_main_paths()
    t5 = time.perf_counter()
    phase_custom_pde()
    phase_campaign_f32()
    phase_bench_measure()
    t6 = time.perf_counter()
    log(f"[time] traces (4p) {t5 - t4:.1f} s, custom PDE, campaign and "
        f"bench (4q-4s) {t6 - t5:.1f} s")
    phase_data_parallel()
    t7 = time.perf_counter()
    log(f"[time] data parallel (4t) {t7 - t6:.1f} s")
    phase_tensor_parallel()
    log(f"[time] tensor parallel (4u) {time.perf_counter() - t7:.1f} s")
    for module in ("jax", "matplotlib"):
        if module in sys.modules:
            raise AssertionError(f"the port imported {module}")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **stats[name]} for name, (src, replaces) in KERNELS.items()]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        missing = [key for key in keys if key not in k]
        if missing:
            raise AssertionError(f"{k['name']}: no {missing}")
    # The redesign order: time lost on the main paths over the bound.
    for k in sorted(kernels, key=lambda k: -k["launches"] * (k["ms"] - k["bound_ms"])):
        log(f"[rank] {k['name']}: launches x (ms - bound_ms) = "
            f"{k['launches'] * (k['ms'] - k['bound_ms']):.1f} ms")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
