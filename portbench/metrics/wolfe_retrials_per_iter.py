"""Trials of the weak-Wolfe search after its first, an L-BFGS
iteration: the program's counters ``lbfgs.wolfe.expand`` (t doubled:
the bracket had no upper end yet) and ``lbfgs.wolfe.bisect`` (t halved
the bracket) over ``lbfgs.iters`` (``pinn_torch/optim/lbfgs.py``),
between the harness's two marks in the untraced window: its first
``count_units`` iterations, or the whole window where it closed before
them.  Each trial is a full loss and gradient.  A program without
those counters gives None."""

from portbench.metrics._program import counter


def read(ctx):
    expand, bisect, iters = (counter(ctx, n) for n in (
        "lbfgs.wolfe.expand", "lbfgs.wolfe.bisect", "lbfgs.iters"))
    if expand is None or bisect is None or not iters:
        return None
    return (expand + bisect) / iters
