#!/usr/bin/env python3
"""Profile the Adam step of the Schrödinger experiment on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and the
CUDA toolkit):

    python3 chip_schrodinger_probe.py

For the fused float32 kernels (``fused_residual: True``) and then the
bf16-stream ones (``fused_residual: "bf16"``) it runs
``pinn_torch.experiments.inf_cont_schrodinger.run`` with the sources'
defaults (the recipe's Adam, no L-BFGS) and prints:

- ms per Adam step on the host clock (the Trainer's own Adam timing,
  100 steps, after a 10-step run that builds and loads the kernels);
- under ``torch.profiler`` (device activity only), runs of 20 and 40
  steps: the difference of the two, over 20 steps, gives the profiled
  ms a step and the device ms a step (the sum of the kernels' device
  times), with the set-up, the final loss and the prediction, which
  both runs share, taken out; the device's busy share of the host-clock
  step and of the profiled one;
- the five kernels with the most device time a step.

The last line is the card's nvidia-smi line.  Without a CUDA device it
exits with code 2.
"""

from __future__ import annotations

import subprocess
import sys


def _profiled(run, hp):
    """Adam seconds and per-kernel (device microseconds, launches) of one
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
    return r["timing"]["adam_s"], kernels


def steps() -> None:
    from pinn_torch.experiments import inf_cont_schrodinger

    run = inf_cont_schrodinger.run
    for fused in (True, "bf16"):
        tag = "bfloat16" if fused == "bf16" else "float32"
        hp = {"device": "cuda", "fused_residual": fused, "nt_epochs": 0,
              "log_frequency": 1000}
        run({**hp, "tf_epochs": 10})
        host = run({**hp, "tf_epochs": 100})["timing"]["adam_s"] * 1e3 / 100
        s20, k20 = _profiled(run, {**hp, "tf_epochs": 20})
        s40, k40 = _profiled(run, {**hp, "tf_epochs": 40})
        step = (s40 - s20) * 1e3 / 20
        per_step = {name: ((us - k20.get(name, (0, 0))[0]) / 1e3 / 20,
                           (n - k20.get(name, (0, 0))[1]) / 20)
                    for name, (us, n) in k40.items()}
        dev = sum(ms for ms, _ in per_step.values())
        print(f"[steps] {tag}: {host:.3f} ms a step (host clock, 100 steps); "
              f"profiled {step:.3f} ms a step, device {dev:.3f} ms a step "
              f"(busy {dev / host:.1%} of the host-clock step, "
              f"{dev / step:.1%} of the profiled one)", flush=True)
        top = sorted(per_step.items(), key=lambda kv: -kv[1][0])[:5]
        for name, (ms, n) in top:
            print(f"[steps] {tag}:   {ms:.4f} ms a step, {n:g} a step: "
                  f"{name[:90]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_schrodinger_probe: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    steps()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
