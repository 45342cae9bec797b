"""The readings that a cell's limits are set from, at the cell's size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds S] [--out FILE]

For each seed it sets the cell up as a run does (inputs, weights, the
program's first checked steps) and, where the cell's phase is judged
where the window left it, runs the window (``--seconds``, by default
``run_seconds``); then it reads, against the float64 reference from the
same inputs:

- ``program``: the program as the configuration states it (the lower
  readings);
- ``control``: the reference itself in the control's precision, in the
  program's place: TF32 products (below the net's IEEE float32) for
  the losses and gradients, float32 (below the float64 vectors) for
  the direction from the program's last history;
- ``half_batch``: the program with half of the collocation points left
  out of its loss, the mean taken over the rest: over the first steps,
  and as the loss at the program's last iterate.

A step that returns its state unchanged reads 1 on ``change_gap`` by
the judge's measure and needs no run.  The benchmark's own runs do not
run this.  One JSON line a seed and a summary go to standard output and
to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def half_batch(loss_fn):
    def loss(params, batch):
        n = batch["X_f"].shape[0] // 2
        return loss_fn(params, {**batch, "X_f": batch["X_f"][:n]})
    return loss


def readings_for_seed(harness, spec, seed, device, n_f=None, seconds=None):
    import torch

    from portbench import judge
    from portbench.reference import precision

    out = {"seed": seed}
    seconds = spec.bench["run_seconds"] if seconds is None else seconds
    t0 = time.perf_counter()
    cell, phase, record, _ = harness.setup(spec, seed, device, n_f)
    final = half_loss = None
    if harness.late(spec):
        phase.warm()
        out["window_units"] = harness.window(phase, seconds, device)[0]
        final = phase.final()
        with torch.no_grad():
            half_loss = float(half_batch(spec.problem.program_loss(
                spec.config, cell.const))(final["params"], final["batch"]))
        del final["params"]
    inputs, leaves0, const = cell.inputs, cell.leaves0, cell.const
    del cell, phase
    gc.collect()
    ref = harness.reference_record(spec, leaves0, inputs, const,
                                   precision.FLOAT64)
    out["program"] = judge.readings(record, ref)
    ctrl = harness.reference_record(spec, leaves0, inputs, const,
                                    precision.TF32)
    out["control"] = judge.readings(ctrl, ref)
    if final is not None:
        late_ref = harness.late_reference(spec, final, const, precision.FLOAT64)
        late_ctrl = harness.late_reference(spec, final, const, precision.TF32)
        out["program"].update(judge.late_readings(final, late_ref))
        out["control"].update(judge.late_readings(late_ctrl, late_ref))
        out["final_losses"] = {"program": final["loss"],
                               "reference": late_ref["loss"],
                               "control": late_ctrl["loss"],
                               "half_batch": half_loss}
    cell, phase, faulty, _ = harness.setup(spec, seed, device, n_f,
                                           loss_wrap=half_batch)
    del cell, phase
    out["half_batch"] = judge.readings(faulty, ref)
    if final is not None:
        out["half_batch"]["final_loss_gap"] = judge.late_readings(
            {**final, "loss": half_loss}, late_ref)["final_loss_gap"]
    out["losses"] = {"program": record["losses"], "reference": ref["losses"],
                     "control": ctrl["losses"], "half_batch": faulty["losses"]}
    out["seconds"] = time.perf_counter() - t0
    gc.collect()
    return out


def summary(rows):
    names = [n for n in rows[0]["program"]]
    s = {}
    for name in names:
        half = [r["half_batch"][name] for r in rows if name in r["half_batch"]]
        s[name] = {"program_max": max(r["program"][name] for r in rows),
                   "control_min": min(r["control"][name] for r in rows),
                   "half_batch_min": min(half) if half else None,
                   "frozen_step": 1.0 if name == "change_gap" else None}
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-f", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    spec = harness.resolve(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings_for_seed(harness, spec, seed, args.device, args.n_f,
                                args.seconds)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    result = {"workload": args.workload, "seeds": len(rows),
              "summary": summary(rows), "rows": rows}
    if args.device == "cuda":
        result["kind"] = torch.cuda.get_device_name()
    print(json.dumps({"workload": args.workload,
                      "summary": result["summary"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
