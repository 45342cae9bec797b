"""Loss evaluations an L-BFGS iteration over the untraced window, from
the optimizer state's own counters (``n_evals`` over ``n_iter``, summed
over the draws the window began)."""


def read(ctx):
    return ctx.evals / ctx.iters if ctx.iters else None
