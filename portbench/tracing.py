"""The traced segment of a ``--trace 1`` run and what is read from it.

The segment runs a fixed number of the cell's units under
``torch.profiler`` (CPU and CUDA activity) between two device
synchronisations, exports the Chrome trace to a temporary file, reads
it and deletes it.  From the trace:

- ``busy_s``: the union of the device's kernel, memcpy and memset
  intervals (``chip_smoke.py`` phase 4p's arithmetic);
- ``kernel_s`` and ``n_kernels``: the summed durations and the number
  of kernel executions (one a launch);
- ``device_ops``: device time by operation name;
- ``idle_gaps``: the device's idle gaps, each put to the innermost host
  event that covers its midpoint, summed by that event's name.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver", "python_function")
_SCAN = 256   # host events looked back through for a gap's cover


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    kernel_s: float = 0.0
    n_kernels: int = 0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def traced(run_units, sync) -> Tuple[Trace, int]:
    """Run ``run_units()`` (which returns the units it ran) under the
    profiler; returns the trace read and the units."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = run_units()
        sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return summarise(events, window_s), units


def summarise(events, window_s: float) -> Trace:
    out = Trace(window_s=window_s)
    device, host = [], []
    ops = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATEGORIES:
            device.append((ts, ts + dur))
            ops[e["name"]] += dur * 1e-6
            if cat == "kernel":
                out.kernel_s += dur * 1e-6
                out.n_kernels += 1
        elif cat in HOST_CATEGORIES:
            host.append((ts, ts + dur, e["name"]))
    out.device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    merged = []
    for a, b in sorted(device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out.busy_s = sum(b - a for a, b in merged) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        gaps[_cover(host, starts, 0.5 * (end + nxt))] += (nxt - end) * 1e-6
    out.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return out


def _cover(host, starts, t: float) -> str:
    """The name of the latest-starting host event that covers ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - _SCAN), -1):
        a, b, name = host[j]
        if b >= t:
            return name
    return "(no host event)"
