"""Accuracy recipes on the PyTorch port: each recipe's stages chained
through checkpoints, its error against the campaign budget, and each
stage's wall-clock and rates.

Counterpart of ``experiments/run_campaign.py`` for all eight recipes:
continuous Burgers inference and identification, Schrödinger, the
discrete-time IRK families (Burgers inference and identification,
Allen–Cahn, KdV) and Navier–Stokes identification.  ``CAMPAIGN``,
``BUDGETS`` and ``PARITY_NAMES`` (the names run when none are given:
every recipe but the three beyond the reference) are copies of that
file's.  Unlike the JAX campaign off the TPU, the port keeps
``fused_residual``: those stages run on the card's kernels.  A
``net_impl: "df32"`` stage runs as native float64.  ``--quick`` cuts
every stage to ``QUICK_OVERRIDES``; ``--f32`` runs every stage in
float32 (``dtype: "float32"``, no ``nt_vector_dtype``) and drops
``net_impl``, as the JAX campaign does wherever df32 is not its engine.

Each recipe prints one JSON line (its error, whether it met the budget,
each stage's error, wall-clock and rates); ``--out FILE`` also writes
the list of them.  ``--verify`` adds a ``VERIFY OK`` or ``VERIFY
REGRESSED`` line a recipe and a closing ``VERIFY PASSED`` or ``VERIFY
FAILED`` line.  A recipe that raises is reported and the others still
run; the exit code is 1 when a recipe raised or, with ``--verify``,
missed its budget.  On a CUDA device the run prints the card's name and
power limit first.  Results are not appended to ``RESULTS.md``, which
holds the JAX package's TPU runs: ``--out`` takes its place.

Usage: ``python -m pinn_torch.experiments.run_campaign [NAME ...]
[--verify] [--quick] [--f32] [--device cpu] [--out FILE]``
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from pinn_torch.device import device_name, resolve_device

CAMPAIGN = {
    "inf_cont_burgers": [
        {"nt_vector_dtype": "float64", "log_frequency": 2000,
         "fused_residual": True,
         "tf_epochs": 1000, "nt_epochs": 15000,
         "nt_line_search": "wolfe", "nt_resample": 1000},
        {"dtype": "float64", "net_impl": "df32", "tf_epochs": 0,
         "nt_epochs": 10000, "log_frequency": 2000,
         "nt_line_search": "wolfe", "nt_resample": 1000,
         "nt_val_every": 500},
    ],
    "inf_cont_schrodinger": [
        {"nt_vector_dtype": "float64", "log_frequency": 2000,
         "tf_epochs": 2000, "tf_lr": 1e-3, "tf_b1": 0.9,
         "tf_eps": None, "nt_epochs": 15000},
        {"dtype": "float64", "tf_epochs": 0, "nt_epochs": 6000,
         "log_frequency": 1000},
    ],
    "inf_disc_burgers": [
        {"nt_vector_dtype": "float64", "nt_dir_impl": "matrix",
         "tf_epochs": 1000, "nt_epochs": 3000, "log_frequency": 1000},
        {"dtype": "float64", "net_impl": "df32", "nt_dir_impl": "matrix",
         "tf_epochs": 0, "nt_epochs": 6000, "log_frequency": 1000}],
    "ide_cont_burgers": [
        {"dtype": "float64", "nt_dir_impl": "matrix", "tf_epochs": 1000,
         "nt_epochs": 10000, "log_frequency": 1000}],
    "ide_disc_burgers": [
        {"nt_vector_dtype": "float64", "nt_dir_impl": "matrix",
         "tf_epochs": 1000, "nt_epochs": 6000, "log_frequency": 1000},
        {"dtype": "float64", "net_impl": "df32", "nt_dir_impl": "matrix",
         "tf_epochs": 0, "nt_epochs": 8000, "log_frequency": 1000}],
    "inf_disc_allencahn": [
        {"nt_vector_dtype": "float64", "nt_dir_impl": "matrix",
         "tf_epochs": 1000, "nt_epochs": 20000, "log_frequency": 2000},
        {"dtype": "float64", "net_impl": "df32", "nt_dir_impl": "matrix",
         "tf_epochs": 0, "nt_epochs": 30000, "log_frequency": 2000}],
    "ide_disc_kdv": [
        {"tf_epochs": 200, "nt_epochs": 10000, "log_frequency": 1000}],
    "ide_cont_navierstokes": [
        {"nt_vector_dtype": "float64", "nt_dir_impl": "matrix",
         "layers": [3, 40, 40, 40, 40, 40, 40, 40, 40, 2],
         "N_u": 10000,
         "tf_epochs": 5000, "nt_epochs": 15000, "log_frequency": 1000}],
}

# The reference-parity campaign (the default when no names are given).
_BEYOND_REFERENCE = ("inf_disc_allencahn", "ide_disc_kdv",
                     "ide_cont_navierstokes")
PARITY_NAMES = [n for n in CAMPAIGN if n not in _BEYOND_REFERENCE]

# Mean relative lambda error for ide_*, rel-L2 otherwise.
BUDGETS = {
    "inf_cont_burgers": 7e-4,
    "inf_cont_schrodinger": 2e-3,
    "inf_disc_burgers": 1.5e-3,
    "ide_cont_burgers": 6e-3,
    "ide_disc_burgers": 4e-4,
    "inf_disc_allencahn": 3e-3,
    "ide_disc_kdv": 5e-4,
    "ide_cont_navierstokes": 1e-2,
}

QUICK_OVERRIDES = {"tf_epochs": 50, "nt_epochs": 200, "log_frequency": 50}


def run_recipe(name: str, workdir: str, device=None, quick: bool = False,
               overrides=None, f32: bool = False) -> dict:
    """Run ``name``'s stages in order, each from the checkpoint of the
    one before (per case for the identification recipes), on
    ``device``.  ``overrides`` update every stage's hp (after
    ``--quick``'s and ``--f32``'s)."""
    mod = importlib.import_module(f"pinn_torch.experiments.{name}")
    dev = resolve_device(device)
    stages, ckpt = [], None
    for i, stage in enumerate(CAMPAIGN[name]):
        hp = {**stage, **(QUICK_OVERRIDES if quick else {})}
        if f32:
            hp["dtype"] = "float32"
            hp.pop("nt_vector_dtype", None)
            hp.pop("net_impl", None)
        hp.update(overrides or {}, device=str(dev))
        if ckpt:
            hp["init_checkpoint"] = ckpt
        ckpt = os.path.join(workdir, f"{name}-stage{i + 1}.npz")
        hp["save_checkpoint"] = ckpt
        t0 = _now(dev)
        result = mod.run(hp, plot=False)
        seconds = _now(dev) - t0
        row = {"stage": i + 1, "error": result["error"],
               "seconds": seconds, "tf_epochs": hp["tf_epochs"],
               "dtype": hp.get("dtype", "float32"),
               "timing": result["timing"]}
        for key in ("lambdas", "lambdas_noisy", "field_errors"):
            if key in result:
                row[key] = result[key]
        stages.append(row)
        print(f"[{name}] stage {i + 1}: error {result['error']:.6e}, "
              f"{seconds:.2f} s", flush=True)
    error = stages[-1]["error"]
    return {"experiment": name, "error": error, "budget": BUDGETS[name],
            "met": error <= BUDGETS[name], "device": device_name(dev),
            "seconds": sum(s["seconds"] for s in stages), "stages": stages}


def _now(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help=f"recipes to run (default: {' '.join(PARITY_NAMES)}; "
                         f"all: {' '.join(CAMPAIGN)})")
    ap.add_argument("--verify", action="store_true",
                    help="hold each recipe's error to its budget")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="every stage in float32, without net_impl")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    names = args.names or PARITY_NAMES
    unknown = [n for n in names if n not in CAMPAIGN]
    if unknown:
        ap.error(f"unknown recipe(s) {unknown}; choose from {list(CAMPAIGN)}")

    if resolve_device(args.device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(f"[card] nvidia-smi: {smi}", flush=True)
    rows, failures = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            try:
                row = run_recipe(name, tmp, args.device, args.quick,
                                 f32=args.f32)
            except Exception:  # report it and run the other recipes
                traceback.print_exc()
                print(f"{name} FAILED", flush=True)
                failures.append(name)
                continue
            print(json.dumps(row), flush=True)
            rows.append(row)
            if args.verify:
                print(f"VERIFY {'OK' if row['met'] else 'REGRESSED'} {name}: "
                      f"{row['error']:.4e} vs budget {row['budget']:.1e}",
                      flush=True)
                if not row["met"]:
                    failures.append(name)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    if args.verify:
        print(f"VERIFY {'FAILED' if failures else 'PASSED'}"
              + (f" ({', '.join(failures)})" if failures else ""), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
