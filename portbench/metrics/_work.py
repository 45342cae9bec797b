"""The least time and the operations of a set of loss evaluations."""


def evaluations(ctx, counts):
    """``(operations, least seconds)`` of the loss evaluations counted
    in ``counts`` (by kind), or None on a card without peaks."""
    from portbench.peaks import bound_s

    ops = least = 0.0
    for kind, n in counts.items():
        o, b = ctx.work.cost(ctx.config, ctx.n_f, kind == "loss_grad")
        t = bound_s(ctx.kind, o, b)
        if t is None:
            return None
        ops += n * o
        least += n * t
    return ops, least
