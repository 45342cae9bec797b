"""The L-BFGS two-loop direction in one CUDA launch.

``two_loop(g, S, Y, k, head, hdiag, m)`` gives what
``pinn_torch.optim.lbfgs._two_loop`` gives, the literal ``scan``
recursion over the ``k`` filled rows of the (m, P) history ring (logical
slot j, oldest first, at ring row ``(head - k + j) mod m``), by one
launch of ``lbfgs_two_loop`` (``pinn_torch/csrc/lbfgs_direction.cu``,
built by ``_build``) in place of ~17 eager launches a pair.  It replaces
no TPU kernel: the JAX package's ``_two_loop`` is a ``lax`` loop that
XLA compiles.  The kernel is one thread-block cluster of
:func:`cluster_size` CTAs; it works in the vectors' own type (float64,
float32 or bfloat16) with the eager version's roundings, sums in a
fixed order (two launches give the same bits) and reads ``hdiag``
through its pointer, so it adds no host read.

``_two_loop`` is the plain version, which ``lbfgs._direction`` takes
for CPU tensors; for CUDA tensors it calls :func:`two_loop`, which
launches or raises.  :func:`check_args` holds the arguments of both
paths to the ring's layout; :func:`two_loop` checks them itself.
Each launch counts ``launch.lbfgs_two_loop`` (``pinn_torch.utils.trace``).
"""

from __future__ import annotations

import torch

from pinn_torch.ops import _build
from pinn_torch.utils import trace

ENTRY = "lbfgs_two_loop"
MAX_CLUSTER = 16
# Entries of a ring row a CTA takes before the cluster grows by one CTA.
# Swept on the H100 (C = 1-16 at P = 3,021 and 30,802, float64, float32
# and bfloat16; PERF.md, the L-BFGS two-loop kernel): a step's time
# follows the entries a thread walks, not their bytes, and levels off
# near 512 entries a CTA.
SLICE = 512
# The kernel's element codes.
_ELEM = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}


def cluster_size(p: int) -> int:
    """CTAs in the kernel's cluster for ``p`` entries, of any of its
    types: one per ``SLICE`` entries, 1 to ``MAX_CLUSTER``."""
    return max(1, min(MAX_CLUSTER, -(-p // SLICE)))


def check_args(g, S, Y, k: int, head: int, hdiag, m: int) -> None:
    """Raise ``ValueError`` unless ``g`` is (P,), ``S`` and ``Y`` are
    (m, P) and ``hdiag`` 0-d, all of one dtype and device, with
    ``0 <= k <= m`` and ``0 <= head < m``."""
    if g.dim() != 1:
        raise ValueError(f"g must be 1-D, got shape {tuple(g.shape)}")
    want = (m, g.shape[0])
    for name, a in (("S", S), ("Y", Y)):
        if tuple(a.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(a.shape)}")
    if hdiag.dim() != 0:
        raise ValueError(f"hdiag must be 0-d, got shape {tuple(hdiag.shape)}")
    for name, a in (("S", S), ("Y", Y), ("hdiag", hdiag)):
        if a.dtype != g.dtype or a.device != g.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}, g "
                             f"{g.dtype} on {g.device}")
    if not 0 <= k <= m:
        raise ValueError(f"k = {k} outside [0, m = {m}]")
    if not 0 <= head < m:
        raise ValueError(f"head = {head} outside [0, m = {m})")


def _launch(g, S, Y, k, head, hdiag, m, cluster) -> torch.Tensor:
    lib = _build.library().lib
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        err = lib.lbfgs_two_loop(
            g.data_ptr(), S.data_ptr(), Y.data_ptr(), hdiag.data_ptr(),
            out.data_ptr(), g.shape[0], m, k, head, _ELEM[g.dtype], cluster,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, ENTRY)
    trace.count("launch." + ENTRY)
    return out


def two_loop(g, S, Y, k: int, head: int, hdiag, m: int) -> torch.Tensor:
    """The direction as a new (P,) tensor, by one launch of the kernel on
    the current stream of ``g``'s device; no synchronisation.  CUDA
    tensors only, contiguous, float64, float32 or bfloat16; anything
    else raises ``ValueError``."""
    check_args(g, S, Y, k, head, hdiag, m)
    if g.dtype not in _ELEM:
        raise ValueError(f"{ENTRY} takes float64, float32 or bfloat16, "
                         f"not {g.dtype}")
    for name, a in (("g", g), ("S", S), ("Y", Y)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{a.stride()}")
    if g.device.type != "cuda":
        raise ValueError(f"{ENTRY} runs on CUDA tensors, not {g.device}")
    if g.shape[0] == 0 or g.shape[0] > 2**31 - 1:
        raise ValueError(f"{ENTRY} takes 1 to 2**31 - 1 entries, got "
                         f"{g.shape[0]}")
    return _launch(g, S, Y, k, head, hdiag, m, cluster_size(g.shape[0]))
