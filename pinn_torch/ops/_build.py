"""Build and load the port's CUDA kernels.

Every ``pinn_torch/csrc/*.cu`` is compiled at first use by its own
``nvcc`` process, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <src>.o pinn_torch/csrc/<src>.cu

then linked by one ``nvcc -shared`` into one shared library with a
plain C interface in ``build/pinn_torch_kernels/``, and loaded with
``ctypes``.  The sources share device code through the header
``pinn_torch/csrc/pt_mlp.cuh``.  The library name carries a hash of
the flags, the sources and the headers, so an edited file builds anew
and an unchanged tree is reused.  ``nvcc`` comes from
``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``; when it is
missing or the build fails this module raises — there is no fallback.

Each C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pinn_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_F = ctypes.c_float

# C signatures of the entry points (pinn_torch/csrc/burgers_train.cu,
# schrodinger_train.cu); each kernel's ``_bf16`` entry takes the same.
_KERNEL_SIGNATURES = {
    "burgers_loss_grad": [_P, _P, _P, _IP, _I, _I, _F, _P, _P, _P, _P],
    "burgers_loss": [_P, _P, _P, _IP, _I, _I, _F, _P, _P, _P],
    "burgers_ide_loss_grad": [_P, _P, _P, _P, _IP, _I, _I, _P, _P, _P, _P],
    "burgers_ide_loss": [_P, _P, _P, _P, _IP, _I, _I, _P, _P, _P],
    "schrodinger_sse_grad": [_P, _P, _IP, _I, _I, _P, _P, _P, _P],
    "schrodinger_sse": [_P, _P, _IP, _I, _I, _P, _P, _P],
}
# float32-only entry points: the v1 SSE pair and burgers_loss_grad_rb
# (burgers_train.cu) and the residual evaluation (residual_eval.cu; X,
# wpack, widths, n_layers, n_pts, lb0, lb1, ub0, ub1, [nu,] out, stream).
_F32_SIGNATURES = {
    "burgers_sse_grad": [_P, _P, _IP, _I, _I, _F, _P, _P, _P, _P],
    "burgers_sse": [_P, _P, _IP, _I, _I, _F, _P, _P, _P],
    # burgers_loss_grad on the register-blocked kernel: no workspace.
    "burgers_loss_grad_rb": [_P, _P, _P, _IP, _I, _I, _F, _P, _P, _P],
    "burgers_residual": [_P, _P, _IP, _I, _I, _F, _F, _F, _F, _F, _P, _P],
    "burgers_residual_fmajor": [_P, _P, _IP, _I, _I, _F, _F, _F, _F, _F,
                                _P, _P],
    "schrodinger_residual": [_P, _P, _IP, _I, _I, _F, _F, _F, _F, _P, _P],
}
SIGNATURES = {
    "burgers_train_sizes": [_IP, _I, _IP, _IP],
    # burgers_train.cu: the partials' sum (pt_mlp.cuh) and its scratch.
    "pt_reduce_rows": [_P, _I, _I, _P, _P],
    "pt_reduce_scratch": [_I, _I],
    # lbfgs_direction.cu: g, S, Y, hdiag, out, P, m, k, head, elem,
    # cluster, stream.
    "lbfgs_two_loop": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "schrodinger_train_sizes": [_IP, _I, _IP, _IP],
    **{name + sfx: sig for name, sig in _KERNEL_SIGNATURES.items()
       for sfx in ("", "_bf16")},
    **_F32_SIGNATURES,
}


def c_define(source: str, name: str) -> int:
    """The integer that ``#define name`` gives in ``csrc/<source>``."""
    text = (CSRC_DIR / source).read_text()
    return int(re.search(rf"^#define {name} (\d+)", text, re.M).group(1))


class KernelBuildFailed(RuntimeError):
    pass


class KernelLibrary:
    """The loaded kernel library, with how it was built."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pt_error_string.argtypes = [_I]
        lib.pt_error_string.restype = ctypes.c_char_p


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildFailed(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of pinn_torch are built "
        "from source at first use and need the CUDA toolkit")


def _sources() -> List[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise KernelBuildFailed(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _digest(srcs: List[Path]) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[Tuple[List[str], int, str]]:
    """Run the commands side by side; (cmd, exit code, output) of each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    return [(cmd, p.returncode, text)
            for cmd, p in procs for text in [p.communicate()[0]]]


def build() -> KernelLibrary:
    """Compile (if needed) and load the kernels; raises on any failure."""
    srcs = _sources()
    out = BUILD_DIR / f"libpinn_torch_kernels_{_digest(srcs)}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return KernelLibrary(out, 0.0, log)
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in srcs]
    tmp = out.with_name(f"{tag}.tmp.so")
    t0 = time.perf_counter()
    try:
        steps = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                          for src, obj in zip(srcs, objs)])
        if all(rc == 0 for _, rc, _ in steps):
            steps += _run_all([[nvcc, "-shared", "-o", str(tmp),
                                *map(str, objs)]])
        log = "".join(text for _, _, text in steps)
        for cmd, rc, text in steps:
            if rc != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildFailed(
                    f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{text}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, out)
    return KernelLibrary(out, seconds, log)


_LIBRARY: Optional[KernelLibrary] = None


def library() -> KernelLibrary:
    """The process-wide kernel library, built on first call."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point of ``lib`` reported a CUDA error."""
    if err != 0:
        name = lib.pt_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")
