"""One run of one cell, found by name in ``BENCHMARK.json``.

A cell names a configuration (``portbench/configs/<config>.json``) and a
traffic mix (``portbench/traffic/<traffic>.json``); its limits are
``portbench/limits/<cell>.json``.  The configuration's ``problem``
names ``portbench/problems/<problem>.py`` (inputs and the program's
loss), ``portbench/work/<problem>.py`` (the work of an evaluation) and
``portbench/reference/<problem>.py`` (the plain loss); the traffic's
``driver`` names ``portbench/drivers/<driver>.py`` (the phase of
training the window drives).  A per-layer metric ``<base>.<part>`` is
read by ``portbench/metrics/<base>.py``.

A run:

1. set-up: draws the inputs and the weights from the seed on the card,
   builds the program's loss and the phase, runs the first
   ``CHECK_STEPS`` steps through the phase's own call (the check
   compares them later), then warms the rest of the window's path;
2. window: whole chunks until ``seconds`` have passed, then a device
   sync; each rate of the driver's ``RATES`` that the cell lists is the
   units, or the loss calls, of all chunks over all the time.  The
   program's counters are marked at the window's start and at the
   first chunk boundary where the window's units reach the traffic's
   ``count_units`` (at its close where they never do): the counter
   readers read between the two marks, the same first units of a
   seed's trajectory on any program that follows it;
3. with ``trace``: a segment of the traffic's ``trace_units`` units
   under the profiler, which the per-layer readers read;
4. where the phase reads the judge's late numbers, its state is taken
   where the window left it (``Phase.final``);
5. the program's state is freed, the reference follows the same first
   steps from the same inputs in float64 and, where the phase has a
   final state, works out the loss at its last iterate and the
   direction from its history; the judge compares.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, NamedTuple, Tuple

import torch

from portbench import judge, tracing
from portbench.metrics import _program
from portbench.reference import precision
from portbench.generate import ROOT, collocation, glorot_weights

HERE = Path(__file__).resolve().parent
CHECK_STEPS = 3
JAX_NAMES = ("jax", "jaxlib", "flax", "pinn")


class UnknownName(LookupError):
    pass


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def find_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise UnknownName(f"no {kind} file named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def find_module(kind: str, name: str):
    if not name.isidentifier() or not (HERE / kind / f"{name}.py").is_file():
        raise UnknownName(f"no {kind} module named {name!r}")
    return importlib.import_module(f"portbench.{kind}.{name}")


def cell_entry(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise UnknownName(f"no cell named {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str):
    """The cell's end-to-end and per-layer metric entries."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench.get("per_layer", [])
             if cell in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in moved)]
    return e2e, layer


def jax_modules():
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(n for n in sys.modules if n.split(".")[0] in JAX_NAMES)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def counted(loss_fn, counts: Counter):
    """``loss_fn`` counted by kind: ``loss_grad`` where autograd wants
    its gradients, else ``loss``."""
    from pinn_torch.params import leaves

    def loss(params, batch):
        grads = torch.is_grad_enabled() and any(a.requires_grad
                                                for a in leaves(params))
        kind = "loss_grad" if grads else "loss"
        counts[kind] += 1
        return loss_fn(params, batch)

    return loss


def _finite_failures(losses) -> int:
    if not losses:
        return 0
    flat = torch.cat([a.reshape(-1) for a in losses])
    return int((~torch.isfinite(flat)).sum())


def reference_record(spec, leaves0, inputs, const, prec):
    """The reference's first steps from ``leaves0`` in ``prec``."""
    loss_mod = find_module("reference", spec.config["problem"])
    opt = find_module("reference", spec.driver.REFERENCE)

    def loss_and_grad(leaves, grads):
        return loss_mod.loss_and_grad(leaves, inputs, const, prec, grads)

    hp = spec.config[spec.driver.REFERENCE]
    return opt.follow(loss_and_grad, leaves0, hp, CHECK_STEPS, prec.dtype)


def late_reference(spec, final, const, prec):
    """The reference at the program's final state in ``prec``: its loss
    at the last iterate over the last batch, and the direction from the
    last history and gradient, split into the leaves' shapes."""
    loss_mod = find_module("reference", spec.config["problem"])
    opt = find_module("reference", spec.driver.REFERENCE)
    dev = final["batch"]["X_f"].device
    with torch.no_grad():
        f, _ = loss_mod.loss_and_grad([a.to(dev) for a in final["leaves"]],
                                      final["batch"], const, prec, False)
    d = opt.direction_from_ring(**final["history"], dtype=prec.dtype)
    sizes = [a.numel() for a in final["leaves"]]
    return {"loss": float(f),
            "direction": [p.reshape(a.shape) for p, a in
                          zip(torch.split(d, sizes), final["leaves"])]}


def late(spec) -> bool:
    """Whether the cell's phase is judged where the window left it."""
    return bool(set(judge.LATE) & set(spec.driver.NUMBERS))


class Mark(NamedTuple):
    """A point of the window: its seconds and units so far, the phase's
    ``totals()`` and a copy of the program's counters."""
    seconds: float
    units: int
    totals: Tuple[int, int]
    counters: Dict[str, int]


def mark(phase, seconds: float, units: int) -> Mark:
    return Mark(seconds, units, phase.totals(), _program.snapshot())


def window(phase, seconds: float, device, count_units=None):
    """Whole chunks until ``seconds`` have passed, then a device sync:
    ``(units, losses of the chunks, seconds, (start, counted))``, where
    ``start`` marks the window's start and ``counted`` the first chunk
    boundary at which its units reach ``count_units``, or its close
    where they never do (or no ``count_units`` is given).  The mark
    inside the window is a dict copy, once a run."""
    losses, units = [], 0
    start, counted = mark(phase, 0.0, 0), None
    t0 = time.perf_counter()
    while True:
        done, chunk_losses = phase.chunk()
        units += done
        if chunk_losses is not None:
            losses.append(chunk_losses)
        if counted is None and count_units and units >= count_units:
            counted = mark(phase, time.perf_counter() - t0, units)
        if done == 0 or time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    return units, losses, window_s, (start, counted or mark(phase, window_s, units))


def resolve(name: str):
    """The cell ``name`` with its configuration, traffic, limits and
    modules, all found by name."""
    bench = load_benchmark()
    entry = cell_entry(bench, name)
    config = find_json("configs", entry["config"])
    traffic = find_json("traffic", entry["traffic"])
    return SimpleNamespace(
        name=name, bench=bench, config=config, traffic=traffic,
        limits=find_json("limits", name),
        problem=find_module("problems", config["problem"]),
        work=find_module("work", config["problem"]),
        driver=find_module("drivers", traffic["driver"]))


def setup(spec, seed: int, device, n_f=None, loss_wrap=None, lap=None):
    """The cell's inputs, weights, loss and phase, after its checked
    first steps.  Returns ``(cell, phase, record, counts)``.  ``lap(name)``,
    where given, marks the end of each part of the set-up."""
    from pinn_torch.params import leaves

    lap = lap or (lambda name: None)
    precision.ieee_matmuls()
    n_f = int(n_f or spec.traffic["N_f"])
    batch, const = spec.problem.make(spec.config, n_f, seed, device)
    params = glorot_weights(spec.config["layers"], seed, device)
    _sync(device)
    lap("inputs")
    counts = Counter()
    loss_fn = spec.problem.program_loss(spec.config, const)
    if loss_wrap is not None:
        loss_fn = loss_wrap(loss_fn)
    cell = SimpleNamespace(
        config=spec.config, traffic=spec.traffic, n_f=n_f, const=const,
        params=params, batch=batch, loss_fn=counted(loss_fn, counts),
        inputs=dict(batch), leaves0=[a.clone() for a in leaves(params)],
        resample=lambda r: {**batch, "X_f": collocation(
            const["lb"], const["ub"], n_f, seed, r, device)})
    phase = spec.driver.Phase(cell)
    _sync(device)
    lap("phase")
    record = phase.check_steps(CHECK_STEPS)
    lap("check_steps")
    return cell, phase, record, counts


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", n_f=None, t_start=None, log=None):
    """One run: returns ``(result, checks)``, the result line's dict and
    the numbers compared with their limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    laps = [("start", t_start)]

    def lap(part):
        laps.append((part, time.perf_counter()))

    lap("imports")
    spec = resolve(name)
    e2e, layer = metrics_of(spec.bench, name)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    lap("device")
    cell, phase, record, counts = setup(spec, seed, device, n_f, lap=lap)
    phase.warm()
    _sync(device)
    lap("warm")
    setup_s = time.perf_counter() - t_start
    parts = ", ".join(f"{p} {b - a:.3f}" for (_, a), (p, b) in zip(laps, laps[1:]))
    log(f"[{name}] seed {seed}: set-up {setup_s:.3f} s ({parts}; "
        f"torch._dynamo loaded: {'torch._dynamo' in sys.modules}), "
        f"check losses {record['losses']}")

    # -- the measured window --------------------------------------------
    counts.clear()
    count_units = spec.traffic.get("count_units")
    units, losses, window_s, (count_from, count_to) = window(
        phase, seconds, device, count_units)
    evals = phase.totals()[1] - count_from.totals[1]
    window_counts = dict(counts)
    loss_calls = sum(window_counts.values())
    failed = _finite_failures(losses)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    counted = (f"the first {count_to.units} units (count_units {count_units}), "
               f"reached at {count_to.seconds:.3f} s"
               if count_units and count_to.units >= count_units
               else f"the whole window ({count_to.units} units)")
    log(f"[{name}] window {window_s:.3f} s, {units} {spec.driver.REFERENCE} "
        f"units, {evals} evaluations, counts {window_counts}; "
        f"counters read over {counted}")

    trace_read = traced_units = None
    traced_counts = {}
    if trace:
        counts.clear()
        target = int(spec.traffic["trace_units"])

        def run_units():
            n = 0
            while n < target:
                done, _ = phase.chunk()
                if done == 0:
                    break
                n += done
            return n

        trace_read, traced_units = tracing.traced(run_units,
                                                  lambda: _sync(device))
        traced_counts = dict(counts)
    final = phase.final() if late(spec) else None

    # -- the program's state goes; the reference follows ----------------
    inputs, leaves0, const = cell.inputs, cell.leaves0, cell.const
    del cell, phase, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_record(spec, leaves0, inputs, const, precision.FLOAT64)
    values = judge.readings(record, ref)
    if final is not None:
        values.update(judge.late_readings(
            final, late_reference(spec, final, const, precision.FLOAT64)))
    correct = judge.verdict(values, spec.limits) and failed == 0
    log(f"[{name}] reference {time.perf_counter() - t_ref:.3f} s, "
        f"losses {ref['losses']}")

    ctx = SimpleNamespace(
        kind=kind, config=spec.config, n_f=int(n_f or spec.traffic["N_f"]),
        work=spec.work, window_s=window_s, units=units,
        counts=window_counts, count_from=count_from, count_to=count_to,
        trace=trace_read, traced_units=traced_units,
        traced_counts=traced_counts)
    metrics = {}
    if trace:
        for m in layer:
            value = find_module("metrics", m["name"].split(".")[0]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values_e2e = {"setup_s": setup_s}
        for rate_name, rate in spec.driver.RATES.items():
            values_e2e[rate_name] = rate(units, loss_calls) / window_s
        for m in e2e:
            metrics[m["name"]] = {"value": values_e2e[m["name"]],
                                  "unit": m["unit"]}

    found = jax_modules()
    if found:
        raise RuntimeError(f"JAX is loaded in the benchmark's process: {found}")
    result = {"correct": bool(correct), "attempted": units, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=trace_read.busy_s,
                                window_s=trace_read.window_s)
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in trace_read.device_ops],
            "idle_gaps": [[n, s] for n, s in trace_read.idle_gaps]}
    checks = {k: {"value": values.get(k, math.nan), "limit": spec.limits[k]}
              for k in spec.limits}
    result["checks"] = checks
    return result, checks
