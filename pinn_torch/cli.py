"""Command-line entry point of the port: ``python -m pinn_torch <cmd> ...``.

Counterpart of ``pinn/cli.py``:

    python -m pinn_torch info                 # torch, CUDA and the cards
    python -m pinn_torch run NAME [hp.json] [--set k=v ...] [--plot] [--list]
    python -m pinn_torch campaign [NAME ...] [--verify] [--quick] [--f32]
                                  [--device D] [--out F]

``run`` drives an experiment of ``pinn_torch.experiments`` (a module
that defines ``DEFAULT_HP`` and ``run``) on its defaults, updated by
the hp file and then by each ``--set key=value`` (the value parsed as
JSON where it parses, else kept as a string); ``--set device=cpu``
runs it on the CPU, and ``--plot`` draws the experiment's figure
(``graph.pdf``, ``graph.png`` and ``hp.json`` under
``experiments/results/``; it needs matplotlib, which nothing else
does).  ``campaign`` is ``pinn_torch.experiments.run_campaign``.  Not
yet ported: ``bench``, which exits non-zero with a message.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import pkgutil
import subprocess
import sys
from typing import Optional

USAGE = __doc__.split("\n\n")[2]


def _list_experiments():
    """The experiment modules: those whose source defines ``DEFAULT_HP``
    and ``run`` (read, not imported)."""
    import pinn_torch.experiments as pkg

    names = []
    for info in pkgutil.iter_modules(pkg.__path__):
        if info.name.startswith("_"):
            continue
        with open(os.path.join(pkg.__path__[0], f"{info.name}.py")) as fh:
            src = fh.read()
        if "\nDEFAULT_HP" in src and "\ndef run(" in src:
            names.append(info.name)
    return sorted(names)


def _parse_set(pairs):
    """--set key=value overrides; values parse as JSON when possible
    (numbers, lists, booleans), else stay strings."""
    out = {}
    for kv in pairs:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"pinn_torch: --set expects key=value, got {kv!r}")
        try:
            out[key] = json.loads(val)
        except json.JSONDecodeError:
            out[key] = val
    return out


def _power_limits():
    """nvidia-smi's ``name, power.limit`` line of each card, or None
    where nvidia-smi cannot be run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.strip() for line in out.splitlines() if line.strip()]


def _cmd_info() -> int:
    import torch

    import pinn_torch
    print(f"pinn_torch {pinn_torch.__version__}")
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("  no CUDA device")
        return 0
    smi = _power_limits()
    for i in range(torch.cuda.device_count()):
        limit = (smi[i] if smi and i < len(smi)
                 else "power limit unknown (nvidia-smi gave no line)")
        print(f"  cuda:{i}  {torch.cuda.get_device_name(i)}  "
              f"[nvidia-smi: {limit}]")
    return 0


def _cmd_run(argv) -> int:
    if "--list" in argv:
        print("\n".join(_list_experiments()))
        return 0
    plot = "--plot" in argv
    sets, rest, it = [], [], iter([a for a in argv if a != "--plot"])
    for a in it:
        if a == "--set":
            sets.append(next(it, ""))
        elif a.startswith("--set="):
            sets.append(a[len("--set="):])
        else:
            rest.append(a)
    if not rest:
        raise SystemExit("pinn_torch run: experiment name required "
                         "(see `python -m pinn_torch run --list`)")
    name, hp_path = rest[0], (rest[1] if len(rest) > 1 else None)
    if name not in _list_experiments():
        raise SystemExit(f"pinn_torch run: no experiment {name!r} (see "
                         "`python -m pinn_torch run --list`)")
    mod = importlib.import_module(f"pinn_torch.experiments.{name}")
    hp = dict(mod.DEFAULT_HP)
    if hp_path:
        with open(hp_path) as f:
            hp.update(json.load(f))
    hp.update(_parse_set(sets))
    if plot:
        if "plot" not in inspect.signature(mod.run).parameters:
            raise SystemExit(f"pinn_torch run: {name} draws no figure")
        result = mod.run(hp, plot=True)
    else:
        result = mod.run(hp)
    if isinstance(result, dict) and "error" in result:
        print(f"error: {result['error']:.4e}")
    return 0


def _cmd_campaign(argv) -> int:
    from pinn_torch.experiments import run_campaign
    return run_campaign.main(argv)


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "info":
        return _cmd_info()
    if cmd == "run":
        return _cmd_run(rest)
    if cmd == "campaign":
        return _cmd_campaign(rest)
    if cmd == "bench":
        raise SystemExit("pinn_torch bench: not ported yet (the port has "
                         "no benchmark; bench.py measures the JAX package)")
    raise SystemExit(f"pinn_torch: unknown command {cmd!r} "
                     "(expected info | run | campaign | bench)")
