"""The loss evaluations' share of their roofline, in %: the least time
the traced segment's evaluations need (their operations over the
card's float32 peak, or their bytes over its memory rate, the larger)
over the summed device time of every kernel in the segment."""

from portbench.metrics._work import evaluations


def read(ctx):
    if ctx.trace is None or ctx.trace.kernel_s <= 0 or not ctx.traced_counts:
        return None
    work = evaluations(ctx, ctx.traced_counts)
    return None if work is None else 100.0 * work[1] / ctx.trace.kernel_s
