"""L-BFGS iterations of the untraced window over its seconds, as the
end-to-end ``lbfgs_iters_per_s`` reads them, for a cell whose end-to-end
rate is its loss evaluations a second: there a seed's line searches set
how many evaluations an iteration takes, and this rate moves with them."""


def read(ctx):
    return ctx.units / ctx.window_s if ctx.units and ctx.window_s > 0 else None
