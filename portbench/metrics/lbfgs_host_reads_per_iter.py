"""Device values L-BFGS reads on the host an iteration, each a host
sync: the program's counters ``lbfgs.host_reads`` over ``lbfgs.iters``
(``pinn_torch/optim/lbfgs.py``), taken after the run, so over all its
iterations (the checked first steps, the window and the traced segment;
the trace changes no read).  An Armijo iteration that takes its first
trial reads 7: the memory's curvature guard, the descent test, the
Armijo test and the four convergence tests; a rejected first trial
adds ``n_ls + 2``.  ``lbfgs_init``'s one read comes with them (once a
history, against ~900 iterations a run)."""

from portbench.metrics._program import counter


def read(ctx):
    reads, iters = (counter(ctx, n) for n in ("lbfgs.host_reads", "lbfgs.iters"))
    return reads / iters if reads is not None and iters else None
