"""Trials of the weak-Wolfe search that halved the bracket, an L-BFGS
iteration: the program's counter ``lbfgs.wolfe.bisect`` over
``lbfgs.iters`` (``pinn_torch/optim/lbfgs.py``), between the harness's
two marks in the untraced window: its first ``count_units`` iterations,
or the whole window where it closed before them.  The split of
``wolfe_retrials_per_iter`` (which is the evaluations an iteration less
one): a bisection follows a trial without sufficient decrease, a step
too long for the model, and a failed search is all bisections; the rest
of the retrials doubled a step too short.  A program without the
counter gives None."""

from portbench.metrics._program import counter


def read(ctx):
    bisect, iters = (counter(ctx, n) for n in ("lbfgs.wolfe.bisect",
                                                 "lbfgs.iters"))
    return bisect / iters if bisect is not None and iters else None
