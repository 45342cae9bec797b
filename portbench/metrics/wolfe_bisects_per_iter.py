"""Trials of the weak-Wolfe search that halved the bracket, an L-BFGS
iteration: the program's counter ``lbfgs.wolfe.bisect`` over
``lbfgs.iters`` (``pinn_torch/optim/lbfgs.py``), taken after the run, so
over all its iterations.  The split of ``wolfe_retrials_per_iter``
(which is the evaluations an iteration less one): a bisection follows a
trial without sufficient decrease, a step too long for the model, and a
failed search is all bisections; the rest of the retrials doubled a
step too short.  A program without the counter gives None."""

from portbench.metrics._program import counter


def read(ctx):
    bisect, iters = (counter(ctx, n) for n in ("lbfgs.wolfe.bisect",
                                                 "lbfgs.iters"))
    return bisect / iters if bisect is not None and iters else None
