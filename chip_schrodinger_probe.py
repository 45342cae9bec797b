#!/usr/bin/env python3
"""Profile the Adam step and the L-BFGS iteration of the Schrödinger
experiment on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_schrodinger_probe.py

For the fused float32 kernels (``fused_residual: True``) and then the
bf16-stream ones (``fused_residual: "bf16"``) it runs
``pinn_torch.experiments.inf_cont_schrodinger.run`` at the sources'
defaults and prints, first for the Adam step (the recipe's Adam, no
L-BFGS):

- ms per Adam step on the host clock (the Trainer's own Adam timing,
  100 steps, after a 10-step run that builds and loads the kernels);
- under ``torch.profiler`` (device activity only), runs of 20 and 40
  steps: the difference of the two, over 20 steps, gives the profiled
  ms a step and the device ms a step (the sum of the kernels' device
  times), with the set-up, the final loss and the prediction, which
  both runs share, taken out; the device's busy share of the host-clock
  step and of the profiled one;
- the five kernels with the most device time a step;

then the same for the L-BFGS iteration, after 200 Adam steps, in two
cases (``LBFGS_CASES``): the stage of ``chip_smoke.py``'s phase 4c
(the recipe's Adam spikes the loss, and L-BFGS then backtracks most
trials, a loss-only launch each, and stops early but for its
resampling: runs of 100 and 200 ``nt_epochs``) and the campaign's
Schrödinger stage 1 (``experiments/run_campaign.py:78-81``, Adam cut
to 200 steps: runs of 20 and 40).  The host clock comes from an
unprofiled run of the longer length; profiled runs of both lengths are
differenced, each divided by the difference of the runs'
``timing["lbfgs_iters"]`` (Armijo can stop early).  The Adam steps
before them are the same in both runs and cancel.

The last line is the card's nvidia-smi line.  Without a CUDA device it
exits with code 2.
"""

from __future__ import annotations

import subprocess
import sys

LBFGS_CASES = (   # (name, hp, the two nt_epochs differenced)
    ("4c", {"tf_epochs": 200, "nt_line_search": "armijo",
            "nt_vector_dtype": "float64", "nt_resample": 50}, (100, 200)),
    ("campaign", {"tf_epochs": 200, "tf_lr": 1e-3, "tf_b1": 0.9,
                  "tf_eps": None, "nt_vector_dtype": "float64"}, (20, 40)),
)


def _profiled(run, hp):
    """Timing and per-kernel (device microseconds, launches) of one
    profiled run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = run(hp)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():   # device-side events only
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            kernels[e.key] = (e.self_device_time_total, e.count)
    return r["timing"], kernels


def _report(tag, unit, host, run, hp, key, seconds, count, lengths=(20, 40)):
    """Profile ``hp`` with ``key`` at both ``lengths`` and print the
    difference per ``unit``: ``seconds(timing)`` is the phase's host
    time, ``count(timing, n)`` the units a run of ``n`` did."""
    lo, hi = lengths
    t_lo, k_lo = _profiled(run, {**hp, key: lo})
    t_hi, k_hi = _profiled(run, {**hp, key: hi})
    units = count(t_hi, hi) - count(t_lo, lo)
    if units <= 0:
        print(f"[{unit}s] {tag}: not measured, the run of {hi} did no "
              f"more {unit}s than the run of {lo}", flush=True)
        return
    step = (seconds(t_hi) - seconds(t_lo)) * 1e3 / units
    per = {name: ((us - k_lo.get(name, (0, 0))[0]) / 1e3 / units,
                  (n - k_lo.get(name, (0, 0))[1]) / units)
           for name, (us, n) in k_hi.items()}
    dev = sum(ms for ms, _ in per.values())
    print(f"[{unit}s] {tag}: {host:.3f} ms per {unit} (host clock); "
          f"profiled {step:.3f} ms per {unit}, device {dev:.3f} ms per {unit} "
          f"(busy {dev / host:.1%} of the host-clock {unit}, "
          f"{dev / step:.1%} of the profiled one; {units:g} {unit}s "
          f"differenced)", flush=True)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:5]
    for name, (ms, n) in top:
        print(f"[{unit}s] {tag}:   {ms:.4f} ms per {unit}, {n:g} per {unit}: "
              f"{name[:90]}", flush=True)


def probe() -> None:
    from pinn_torch.experiments import inf_cont_schrodinger

    run = inf_cont_schrodinger.run
    for fused in (True, "bf16"):
        tag = "bfloat16" if fused == "bf16" else "float32"
        hp = {"device": "cuda", "fused_residual": fused, "nt_epochs": 0,
              "log_frequency": 1000}
        run({**hp, "tf_epochs": 10})
        host = run({**hp, "tf_epochs": 100})["timing"]["adam_s"] * 1e3 / 100
        _report(tag, "step", host, run, hp, "tf_epochs",
                lambda t: t["adam_s"], lambda t, n: n)

        for case, lbfgs_hp, lengths in LBFGS_CASES:
            case_hp = {**hp, **lbfgs_hp}
            t = run({**case_hp, "nt_epochs": lengths[1]})["timing"]
            host = t["lbfgs_s"] * 1e3 / t["lbfgs_iters"]
            _report(f"{tag} {case}", "iteration", host, run, case_hp,
                    "nt_epochs", lambda t: t["lbfgs_s"],
                    lambda t, n: t["lbfgs_iters"], lengths)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_schrodinger_probe: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    probe()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
