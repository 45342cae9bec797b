"""The sum of the fused kernels' partials' share of its roofline, in %:
the bytes the traced segment's evaluations need it to move (the work
module's ``reduce_bytes``: the partials read once, the sums written
once) over the card's memory rate, divided by the summed device time of
the ``pt_reduce`` kernels among the segment's device operations.  None
where the work module counts no such bytes, or where no ``pt_reduce``
kernel is among the operations the trace lists (its ten largest)."""

from portbench.peaks import bound_s

KERNEL = "pt_reduce"


def read(ctx):
    reduce_bytes = getattr(ctx.work, "reduce_bytes", None)
    if ctx.trace is None or reduce_bytes is None or not ctx.traced_counts:
        return None
    seconds = sum(s for name, s in ctx.trace.device_ops if KERNEL in name)
    if seconds <= 0:
        return None
    n_bytes = sum(n * reduce_bytes(ctx.config, ctx.n_f, kind == "loss_grad")
                  for kind, n in ctx.traced_counts.items())
    least = bound_s(ctx.kind, 0.0, n_bytes)
    return None if least is None else 100.0 * least / seconds
