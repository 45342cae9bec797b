"""Figure creation and results persistence.

Counterpart of ``pinn/utils/plotting.py``: golden-ratio figure sizing,
``newfig``/``savefig`` (pdf + png) and ``save_result_dir``, which writes
``<save_path>/results/<timestamp>-<script>/{graph.pdf, graph.png,
hp.json}``, with no LaTeX (mathtext draws the labels) and the
non-interactive Agg backend.  matplotlib is imported when the first
figure is asked for, so the package trains, serves and runs its chip
checks on a machine without it.
"""

from __future__ import annotations

import json
import os
import sys
from datetime import datetime

import numpy as np

GOLDEN_MEAN = (np.sqrt(5.0) - 1.0) / 2.0
_TEXT_WIDTH_IN = 390.0 / 72.27  # LaTeX textwidth in inches

# Relative save paths resolve against the repo root, not the process
# cwd: experiments pass save_path="experiments", and a run started from
# inside experiments/ must not create experiments/experiments/.
_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, imported at first use."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def figsize(scale: float, nplots: float = 1.0):
    width = _TEXT_WIDTH_IN * scale
    return [width, nplots * width * GOLDEN_MEAN]


def newfig(width: float, nplots: float = 1.0):
    fig = pyplot().figure(figsize=figsize(width, nplots))
    ax = fig.add_subplot(111)
    return fig, ax


def savefig(filename: str, crop: bool = True):
    plt = pyplot()
    kw = dict(bbox_inches="tight", pad_inches=0.02) if crop else {}
    plt.savefig(f"{filename}.pdf", **kw)
    plt.savefig(f"{filename}.png", dpi=150, **kw)


def save_result_dir(save_path: str, save_hp: dict) -> str:
    """Persist the current figure and ``save_hp`` under
    ``<save_path>/results/<stamp>-<script>/``; returns that directory."""
    if not os.path.isabs(save_path):
        save_path = os.path.join(_REPO_ROOT, save_path)
    script = os.path.splitext(os.path.basename(sys.argv[0]))[0] or "run"
    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    res_dir = os.path.join(save_path, "results", f"{stamp}-{script}")
    os.makedirs(res_dir, exist_ok=True)
    print("Saving results to directory ", res_dir)
    savefig(os.path.join(res_dir, "graph"))
    with open(os.path.join(res_dir, "hp.json"), "w") as fh:
        json.dump(save_hp, fh)
    return res_dir
