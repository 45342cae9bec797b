#!/usr/bin/env python3
"""Time the Burgers kernels on one NVIDIA GPU, sweep the block of the
narrow kernels (``pinn_torch/csrc/pt_narrow.cuh``), and compare the
compiled code of two trees.

Usage (from the repository root, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_narrow_probe.py [--tree DIR] [--sweep] [--sass DIR]

At the inference flagship ([2, 20x8, 1], N = 10,100, ``chip_smoke.py``'s
seeded inputs) it prints, for ``burgers_loss_grad``,
``burgers_loss_grad_bf16``, ``burgers_loss`` and ``burgers_loss_bf16``
(PERF.md rows 1, 1b, 2, 2b), at the identification flagship ([2, 20x8,
1], N = 2,000) for the four ``burgers_ide_*`` entries (rows 3-4b), and
at the facade's v1 SSE ([2, 20x8, 1], N = 10,000, the inputs of
``chip_smoke.py``'s phase 3e) for ``burgers_sse_grad`` and
``burgers_sse`` (rows 5, 6), the median ms a call through the wrapper
(CUDA events, 50 calls) and the device ms a call of each kernel the
call launches (torch.profiler, 20 calls); so too for the residual
evaluation (rows 9-11) at the inputs of phase 3e's times (both Burgers
layouts on the 200,000-point pool, Schrödinger's on its grid) and rows 9
and 10 also on the Burgers grid.  Row 1 runs
``pt_narrow_rb.cuh``'s register-blocked kernel where the tree has it
(float32 streams at hidden width 20), rows 1b, 3, 3b and 5
``pt_narrow.cuh``'s loss+grad kernel, rows 2, 2b, 4, 4b and 6 its
loss-only kernel, rows 9 and 10 its eval kernel (on the points-major
and the features-major input policy) and row 11 ``pt_tile.cuh``'s eval
kernel.  Row 1 is also timed at the benchmark cells' N = 1,000,100,
and at both sizes through the narrow kernel's entry as well
(``burgers_loss_grad`` launched as such), each with its bound, the
SHA-256 of its loss and gradients, and ptxas's lines of both kernels.
So that two trees' outputs can be compared bit for bit, it prints the
loss of each of rows 1-6 and the lambda adjoints (A1, -A2) of rows 3
and 3b as hex floats, and the SHA-256 of the bytes of rows 9-11's
outputs at each of phase 3e's residual inputs
(``chip_smoke._residual_cases``: the pool, both grids, the edges).

``--tree DIR`` times the ``pinn_torch`` of the checkout at DIR (another
commit unpacked there, say) with this script's measurement code, so
that two trees are timed alike on one card, in turns.

``--sweep`` builds the tree's sources once for each block size in
``SWEEP`` (a copy under ``build/``, every block constant of
``pt_narrow.cuh`` in ``CONSTANTS`` rewritten to it; the tree's own
library is untouched), prints each build's ptxas lines for the narrow
kernels on every head, checks that each gives the default build's
outputs bit for bit for rows 1-6 and rows 9 and 10 on the
200,000-point pool (the block size changes the order of no sum), and
times those twelve, in the default build and at each size, in two
interleaved rounds.

``--sass DIR`` builds each source of this tree and of the checkout at
DIR ``SASS_BUILDS`` times as a cubin with the library's flags, sixteen
side by side, disassembles them (``cuobjdump -sass``) and prints, for
each kernel function, whether its instructions are identical in both
trees, share a form (a function the compiler gave more than one form),
differ (with the differing lines) or are in one only.

The last line is the card's nvidia-smi line.  Without a CUDA device it
exits with code 2.
"""

from __future__ import annotations

import argparse
import hashlib
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
          "burgers_loss", "burgers_loss_bf16",             # 2, 2b
          "burgers_ide_loss_grad", "burgers_ide_loss_grad_bf16",   # 3, 3b
          "burgers_ide_loss", "burgers_ide_loss_bf16",     # 4, 4b
          "burgers_sse_grad", "burgers_sse")                      # 5, 6
SWEPT = NARROW + ("burgers_residual", "burgers_residual_fmajor")  # 9, 10
# The narrow kernel templates and the heads (the eval kernel: the input
# policies) they are built for.
NARROW_KERNELS = tuple((kernel, head)
                       for kernel in ("pt_narrow_loss_grad_kernel",
                                      "pt_narrow_loss_kernel")
                       for head in ("BurgersInfHead", "BurgersIdeHead",
                                    "BurgersSseHead")) \
    + tuple(("pt_narrow_eval_kernel", policy)
            for policy in ("RawPointsMajor", "RawFeaturesMajor"))
CONSTANTS = ("kPtNarrowThreads", "kPtNarrowLossThreads",
             "kPtNarrowLossThreadsFew")
# Builds of each source a tree for --sass: nvcc does not always give a
# function the same SASS from the same source (two FMULs' operands
# swapped from one build to the next, PERF.md), so one build a tree can
# show a difference that no source change made.
SASS_BUILDS = 12


def _smoke():
    """chip_smoke.py's helpers (inputs, timers), loaded from this
    script's own checkout whichever tree is timed."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _residual_fns(cs):
    """[(tag, entry, call)] of rows 9-11 at each of phase 3e's residual
    inputs, in its order."""
    import torch
    from pinn_torch.ops import residual as rs
    fns = []
    for layers, params, X, lb, ub in cs._residual_cases("burgers"):
        tag = cs._shape_tag(layers, X.shape[0])
        for name in ("burgers_residual", "burgers_residual_fmajor"):
            fns.append((tag, name, lambda f=getattr(rs, name), p=params, x=X,
                        lb=lb, ub=ub: f(p, x, lb, ub, cs.NU)))
    for layers, params, X, lb, ub in cs._residual_cases("schrodinger"):
        fns.append((cs._shape_tag(layers, X.shape[0]), "schrodinger_residual",
                    lambda p=params, x=X, lb=lb, ub=ub: torch.cat(
                        rs.schrodinger_residual(p, x, lb, ub), dim=1)))
    return fns


def _calls(cs):
    """The timed calls by entry point: rows 1-2b at the inference
    flagship, rows 3-4b at identification's (N = 2,000), rows 5-6 at
    the facade's v1 SSE (N = 10,000), rows 9-11 where phase 3e times
    them (both Burgers layouts on the 200,000-point pool, Schrödinger's
    on its grid), and rows 9 and 10 on the Burgers grid."""
    from pinn_torch.ops import fused_train as ft
    args = cs._kernel_inputs(cs.FLAGSHIP, 100, 10000, seed=100)
    ide = cs._ide_inputs(cs.FLAGSHIP, 2000, cs.IDE_LAMBDAS[0], seed=200)
    layers, n = cs.SSE_SHAPES[0]
    sse = cs._sse_inputs(layers, n, seed=400)
    calls = {"burgers_sse_grad": lambda: ft.burgers_sse_grad(*sse, cs.NU),
             "burgers_sse": lambda: ft.burgers_sse(*sse, cs.NU)}
    fns = _residual_fns(cs)
    for _, name, fn in fns:   # each entry at its problem's first shape
        calls.setdefault(name, fn)
    for _, name, fn in fns[2:4]:   # 3e's second shape
        calls[name + " (grid)"] = fn
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


def _row1_calls(cs):
    """Row 1 at N = 10,100 and 1,000,100 through the wrapper (the
    register-blocked kernel at width 20, in a tree that has it) and
    through the narrow kernel's entry: {tag: (n, call)}."""
    from pinn_torch.ops import fused_train as ft
    calls = {}
    for n in (10100, 1000100):
        args = cs._kernel_inputs(cs.FLAGSHIP, 100, n - 100, seed=100)

        def narrow(a=args):
            a0, aux, z1row, z2row, wt_args = a
            out = ft.launch("burgers_loss_grad", "burgers_train_sizes",
                            ft._BURGERS_LIMITS, a0, [aux], z1row, z2row,
                            wt_args, [float(cs.NU)])
            return ft._unpack(out, z1row, z2row, wt_args)

        calls[f"row 1 N={n}"] = (n, lambda a=args: ft.burgers_loss_grad(*a, cs.NU))
        calls[f"row 1 narrow N={n}"] = (n, narrow)
    return calls


def _outputs(cs, fn):
    """A call's outputs as flat pieces: [loss, *grads, ...], [loss] or
    [residuals]."""
    out = fn()
    return cs._flat(out) if isinstance(out, tuple) else [out.reshape(-1)]


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
        text = hdr.read_text()
        for const in CONSTANTS:
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {nt};", text)
            if n != 1:
                raise RuntimeError(f"{const} not found in pt_narrow.cuh")
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
    want = {name: _outputs(cs, calls[name]) for name in SWEPT}
    for nt, lib in libs.items():
        _build._LIBRARY = lib
        regs = {f"{kernel} {head}": cs._ptxas_lines(kernel, False, head)
                for kernel, head in NARROW_KERNELS}
        for name in SWEPT:
            got = _outputs(cs, calls[name])
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want[name])):
                raise AssertionError(f"{nt} threads: {name} differs from the "
                                     "default build")
        print(f"[sweep] {nt} threads: {regs}; outputs of "
              f"{', '.join(SWEPT)} bitwise the default build's", flush=True)
    libs = {"default": default, **{f"{nt} threads": lib
                                   for nt, lib in libs.items()}}
    for rnd in range(2):
        for tag, lib in libs.items():
            _build._LIBRARY = lib
            for name in SWEPT:
                _time(cs, f"sweep round {rnd} {tag}", name, calls[name])
    _build._LIBRARY = default


def _sass_functions(lib_path: Path) -> dict:
    """{kernel function: its SASS lines} of a library.  A function is
    named from its first ``pt_`` on, which drops the anonymous
    namespace's per-file prefix; a name that repeats (a kernel of a
    header in several sources) gets its count.  Each instruction keeps
    both halves of its encoding (the second holds the scheduling
    bits)."""
    from pinn_torch.ops import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : \S*?(pt_\w+)", line)
        if m:
            name, k = m.group(1), 1
            while name + (f" #{k}" if k > 1 else "") in funcs:
                k += 1
            cur = funcs.setdefault(name + (f" #{k}" if k > 1 else ""), [])
        elif cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            cur.append(re.sub(r"\s+", " ", line.strip()))
        elif cur and re.match(r"\s*/\* 0x[0-9a-f]+ \*/\s*$", line):
            cur[-1] += " " + line.strip()
    return funcs


def _sass_forms(trees: dict) -> dict:
    """{tree: {"<source>: <function>": Counter of its SASS forms}}: each
    ``*.cu`` of each tree's csrc directory built SASS_BUILDS times as a
    cubin with the library's flags, sixteen builds side by side."""
    from collections import Counter
    from pinn_torch.ops import _build
    nvcc = _build.find_nvcc()
    root = _build.BUILD_DIR.parent / "sass"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cmds, outs = [], []
    for t, (tag, csrc) in enumerate(trees.items()):
        for src in sorted(Path(csrc).glob("*.cu")):
            for k in range(SASS_BUILDS):
                out = root / f"{t}.{src.stem}.{k}.cubin"
                cmds.append([nvcc, *_build.NVCC_FLAGS, "-cubin", "-o",
                             str(out), str(src)])
                outs.append((tag, src.stem, out))
    steps = []
    for i in range(0, len(cmds), 16):   # 16 nvcc processes at a time
        steps += _build._run_all(cmds[i:i + 16])
    for cmd, rc, text in steps:
        if rc != 0:
            raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{text}")
    forms = {tag: {} for tag in trees}
    for tag, stem, out in outs:
        for name, lines in _sass_functions(out).items():
            forms[tag].setdefault(f"{stem}: {name}", Counter())[tuple(lines)] += 1
    return forms


def _sass(other: str) -> None:
    """Compare the SASS of this tree's kernels with the checkout at
    ``other``'s, function by function, over SASS_BUILDS builds of each
    source in each tree: identical (one form, the same in both), a form
    in both trees (the compiler gave some function more than one form),
    differs (no form in common: the diff of each tree's most frequent
    form) or in one tree only.  A form is named by the first ten hex
    digits of its SHA-256."""
    import difflib
    from pinn_torch.ops import _build
    forms = _sass_forms({other: Path(other) / "pinn_torch" / "csrc",
                         "this tree": _build.CSRC_DIR})
    a, b = forms[other], forms["this tree"]

    def counts(c):
        return ", ".join(
            f"{hashlib.sha256(chr(10).join(f).encode()).hexdigest()[:10]} x{n}"
            for f, n in c.most_common())

    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            where, c = (other, a) if name in a else ("this tree", b)
            print(f"[sass] only in {where}: {name} "
                  f"({len(next(iter(c[name])))} instructions)", flush=True)
            continue
        fa, fb = a[name], b[name]
        if len(fa) == len(fb) == 1 and fa.keys() == fb.keys():
            print(f"[sass] identical: {name} ({len(next(iter(fa)))} "
                  "instructions)", flush=True)
            continue
        verdict = "a form in both trees" if fa.keys() & fb.keys() else "DIFFERS"
        print(f"[sass] {verdict}: {name} (over {SASS_BUILDS} builds each; "
              f"{other}: {counts(fa)}; this tree: {counts(fb)})", flush=True)
        if verdict == "DIFFERS":
            diff = [d for d in difflib.unified_diff(
                list(fa.most_common(1)[0][0]), list(fb.most_common(1)[0][0]),
                lineterm="", n=0) if d[:1] in "+-" and d[:3] not in ("---", "+++")]
            for d in diff[:40]:
                print(f"[sass]   {d}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="time the pinn_torch of this checkout")
    ap.add_argument("--sweep", action="store_true",
                    help="sweep the narrow kernels' block size")
    ap.add_argument("--sass", metavar="DIR",
                    help="compare the kernels' SASS with this checkout's")
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
    for kernel in ("pt_narrow_rb_loss_grad_kernel", "pt_narrow_loss_grad_kernel"):
        print(f"[probe] {tag} ptxas {kernel} (BurgersInfHead, f32): "
              f"{cs._ptxas_lines(kernel, False, 'BurgersInfHead')}", flush=True)
    for name, (n, fn) in _row1_calls(cs).items():
        _time(cs, tag, name, fn)
        bound_ms, by = cs._bound(cs.FLAGSHIP, n, True, False, 3)
        digest = hashlib.sha256(b"".join(
            a.float().contiguous().cpu().numpy().tobytes()
            for a in _outputs(cs, fn))).hexdigest()
        print(f"[probe] {tag} {name}: bound {bound_ms:.5f} ms ({by}); "
              f"outputs sha256 {digest}", flush=True)
    for name in NARROW:
        out = _outputs(cs, calls[name])
        glam = (", glam " + ", ".join(float(v).hex() for v in out[-1])
                if name.startswith("burgers_ide_loss_grad") else "")
        print(f"[probe] {tag} {name} outputs: loss {float(out[0]).hex()}"
              f"{glam}", flush=True)
    for shape, name, fn in _residual_fns(cs):
        out = fn().float().contiguous().cpu().numpy()
        print(f"[probe] {tag} {name} {shape} outputs: sha256 "
              f"{hashlib.sha256(out.tobytes()).hexdigest()}", flush=True)
    if opts.sweep:
        _sweep(cs)
    if opts.sass:
        _sass(opts.sass)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
