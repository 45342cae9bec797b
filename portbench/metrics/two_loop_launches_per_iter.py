"""Launches of the L-BFGS two-loop kernel an iteration: the program's
counters ``launch.lbfgs_two_loop`` over ``lbfgs.iters``
(``pinn_torch/ops/lbfgs_direction.py``, ``pinn_torch/optim/lbfgs.py``),
between the harness's two marks in the untraced window: its first
``count_units`` iterations, or the whole window where it closed before
them.  Every iteration but the first of a history launches it once, so
a stretch with no fresh draw in it reads 1; a program that runs the
direction as eager operations has no such counter, and the metric is
left out.

An indicator of which mechanism computed the direction, not a quantity
to raise: its ``better`` is only the direction the benchmark's format
asks every metric for.  A program that folds the direction into another
launch reads lower, or nothing, and is not the worse for it."""

from portbench.metrics._program import counter


def read(ctx):
    launches, iters = (counter(ctx, n)
                       for n in ("launch.lbfgs_two_loop", "lbfgs.iters"))
    return launches / iters if launches is not None and iters else None
