"""Spans and counters inside the port, at the layer boundaries of its
training step.

The JAX package has no counterpart: there a chunk of steps is one
compiled program, whose insides ``jax.profiler`` names by its
operations.  Here every step is eager Python on the host, and what the
host does between two launches decides how long the device waits.  So
the port marks its own layers.

- :func:`span` ``(name)``: while a ``torch.profiler`` runs (an
  operator's hp["trace_dir"], a benchmark's traced segment), a
  ``torch.profiler.record_function("pinn_torch." + name)``, which puts
  the span on the profiler's trace and clock beside the device's
  kernels, and whose host seconds :func:`span_totals` adds up;
  otherwise one shared null context.  Without a profiler a span costs
  a check and a ``with``; it never reads a device value.
- :func:`count` ``(name, n=1)``, :func:`counters`, :func:`delta`: one
  process-wide flat dict of ints, always on.

Names: the first component is the layer (``adam``, ``lbfgs``,
``loss``, ``trainer``); ``pinn_torch/train.py``'s docstring lists the
spans, and the counters are ``lbfgs.host_reads`` (each device value
L-BFGS reads on the host), ``lbfgs.iters`` and ``launch.<entry>`` (the
CUDA launches of each C entry point of ``pinn_torch.ops``).  Nothing is
written to disk here.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

import torch

PREFIX = "pinn_torch."

_NULL = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_span_totals: Dict[str, list] = {}   # name -> [calls, host seconds]
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    """``record_function`` with the host seconds of each call added to
    :func:`span_totals`."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        total = _span_totals.setdefault(self.name, [0, 0.0])
        total[0] += 1
        total[1] += seconds
        return False


def span(name: str):
    """The span ``pinn_torch.<name>`` while a profiler runs, else a null
    context (the same object every call)."""
    if _profiling():
        return _Span(name)
    return _NULL


def span_totals() -> Dict[str, Tuple[int, float]]:
    """``{name: (calls, host seconds)}`` of the spans entered while a
    profiler ran, since the process started."""
    return {name: (n, s) for name, (n, s) in _span_totals.items()}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_counts)


def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """The counters that moved from ``before`` to ``after`` (two
    :func:`counters` snapshots), by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
