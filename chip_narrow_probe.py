#!/usr/bin/env python3
"""Time the Burgers kernels on one NVIDIA GPU, and sweep the block of
the narrow loss+grad kernel (``pinn_torch/csrc/pt_narrow.cuh``).

Usage (from the repository root, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_narrow_probe.py [--tree DIR] [--sweep]

At the inference flagship ([2, 20x8, 1], N = 10,100, ``chip_smoke.py``'s
seeded inputs) it prints, for ``burgers_loss_grad``,
``burgers_loss_grad_bf16``, ``burgers_loss`` and ``burgers_loss_bf16``
(PERF.md rows 1, 1b, 2, 2b), and at the identification flagship ([2,
20x8, 1], N = 2,000) for the four ``burgers_ide_*`` entries (rows 3-4b),
the median ms a call through the wrapper (CUDA events, 50 calls) and
the device ms a call of each kernel the call launches (torch.profiler,
20 calls).  Rows 1, 1b, 3 and 3b run ``pt_narrow.cuh``'s kernel, rows
2, 2b, 4 and 4b ``pt_mlp.cuh``'s loss-only kernel.  For rows 3 and 3b
it also prints the loss and the lambda adjoints (A1, -A2) as hex
floats, so that two trees' outputs can be compared bit for bit.

``--tree DIR`` times the ``pinn_torch`` of the checkout at DIR (another
commit unpacked there, say) with this script's measurement code, so
that two trees are timed alike on one card, in turns.

``--sweep`` builds the tree's sources once for each block size in
``SWEEP`` (a copy under ``build/``, the constant ``kPtNarrowThreads``
rewritten; the tree's own library is untouched), prints each build's
ptxas lines for the narrow kernel on both heads, checks that each gives
the default build's loss and gradients bit for bit for rows 1, 1b, 3 and
3b (the block size changes the order of no sum), and times those four
at each size in two interleaved rounds.

The last line is the card's nvidia-smi line.  Without a CUDA device it
exits with code 2.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SWEEP = (128, 192, 256, 320, 384, 448, 512, 640)
NARROW = ("burgers_loss_grad", "burgers_loss_grad_bf16",   # rows 1, 1b
          "burgers_ide_loss_grad", "burgers_ide_loss_grad_bf16")   # 3, 3b
HEADS = ("BurgersInfHead", "BurgersIdeHead")


def _smoke():
    """chip_smoke.py's helpers (inputs, timers), loaded from this
    script's own checkout whichever tree is timed."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _calls(cs):
    """The timed calls by entry point: rows 1-2b at the inference
    flagship, rows 3-4b at identification's (N = 2,000)."""
    from pinn_torch.ops import fused_train as ft
    args = cs._kernel_inputs(cs.FLAGSHIP, 100, 10000, seed=100)
    ide = cs._ide_inputs(cs.FLAGSHIP, 2000, cs.IDE_LAMBDAS[0], seed=200)
    calls = {}
    for sfx, bf16 in (("", False), ("_bf16", True)):
        calls.update({
            "burgers_loss_grad" + sfx:
                lambda b=bf16: ft.burgers_loss_grad(*args, cs.NU, bf16=b),
            "burgers_loss" + sfx:
                lambda b=bf16: ft.burgers_loss(*args, cs.NU, bf16=b),
            "burgers_ide_loss_grad" + sfx:
                lambda b=bf16: ft.burgers_ide_loss_grad(*ide, bf16=b),
            "burgers_ide_loss" + sfx:
                lambda b=bf16: ft.burgers_ide_loss(*ide, bf16=b)})
    return calls


def _time(cs, tag, name, fn):
    ms = cs._median_ms(fn)
    dev = cs._device_ms(fn)
    print(f"[probe] {tag} {name}: median {ms:.4f} ms through the wrapper; "
          f"device ms a call: total {sum(dev.values()):.5f}; "
          + ", ".join(f"{k} {v:.5f}" for k, v in dev.items()), flush=True)


def _variants(sizes):
    """Build the sources at each block size: {size: KernelLibrary}."""
    from pinn_torch.ops import _build
    nvcc = _build.find_nvcc()
    root = _build.BUILD_DIR.parent / "narrow_sweep"
    shutil.rmtree(root, ignore_errors=True)
    compiles, links, outs = [], [], {}
    for nt in sizes:
        csrc = root / f"threads{nt}"
        shutil.copytree(_build.CSRC_DIR, csrc)
        hdr = csrc / "pt_narrow.cuh"
        text, n = re.subn(r"constexpr int kPtNarrowThreads = \d+;",
                          f"constexpr int kPtNarrowThreads = {nt};",
                          hdr.read_text())
        if n != 1:
            raise RuntimeError("kPtNarrowThreads not found in pt_narrow.cuh")
        hdr.write_text(text)
        objs = []
        for src in sorted(csrc.glob("*.cu")):
            objs.append(str(src.with_suffix(".o")))
            compiles.append([nvcc, *_build.NVCC_FLAGS, "-c", "-o", objs[-1],
                             str(src)])
        outs[nt] = csrc / "lib.so"
        links.append([nvcc, "-shared", "-o", str(outs[nt]), *objs])
    t0 = time.perf_counter()
    steps = _build._run_all(compiles)
    if all(rc == 0 for _, rc, _ in steps):
        steps += _build._run_all(links)
    for cmd, rc, text in steps:
        if rc != 0:
            raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{text}")
    print(f"[sweep] {len(sizes)} builds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {nt: _build.KernelLibrary(out, 0.0, "".join(
        text for cmd, _, text in steps if str(out.parent) + "/" in cmd[-1]))
        for nt, out in outs.items()}


def _sweep(cs) -> None:
    import torch
    from pinn_torch.ops import _build
    calls = _calls(cs)
    default = _build.library()
    libs = _variants(SWEEP)
    want = {name: cs._flat(calls[name]()) for name in NARROW}
    for nt, lib in libs.items():
        _build._LIBRARY = lib
        regs = {head: cs._ptxas_lines("pt_narrow_loss_grad_kernel", False, head)
                for head in HEADS}
        for name in NARROW:
            got = cs._flat(calls[name]())
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want[name])):
                raise AssertionError(f"{nt} threads: {name} differs from the "
                                     "default build")
        print(f"[sweep] {nt} threads: {regs}; loss and gradients of "
              f"{', '.join(NARROW)} bitwise the default build's", flush=True)
    for rnd in range(2):
        for nt, lib in libs.items():
            _build._LIBRARY = lib
            for name in NARROW:
                _time(cs, f"sweep round {rnd} {nt} threads", name, calls[name])
    _build._LIBRARY = default


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="time the pinn_torch of this checkout")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep the narrow kernel's block size")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_narrow_probe: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if opts.tree:
        sys.path.insert(0, os.path.abspath(opts.tree))
    cs = _smoke()
    import pinn_torch
    tree = Path(pinn_torch.__file__).resolve().parents[1]
    tag = "tree " + (opts.tree or ".")
    print(f"[probe] {tag}: pinn_torch from {tree}", flush=True)
    calls = _calls(cs)
    for name, fn in calls.items():
        _time(cs, tag, name, fn)
    for name in NARROW[2:]:
        out = cs._flat(calls[name]())
        print(f"[probe] {tag} {name} outputs: loss {float(out[0]).hex()}, "
              f"glam {', '.join(float(v).hex() for v in out[-1])}", flush=True)
    if opts.sweep:
        _sweep(cs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
