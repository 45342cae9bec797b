"""Loss evaluations an L-BFGS iteration, from the optimizer state's own
counters (``n_evals`` over ``n_iter``, summed over the draws), between
the harness's two marks in the untraced window: its first
``count_units`` iterations, the same stretch of a seed's trajectory on
any program that follows it bit for bit, or the whole window where it
closed before them."""


def read(ctx):
    (i0, e0), (i1, e1) = ctx.count_from.totals, ctx.count_to.totals
    return (e1 - e0) / (i1 - i0) if i1 > i0 else None
