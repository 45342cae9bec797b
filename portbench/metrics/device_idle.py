"""The device's idle share of the traced segment, in %: 1 - the union
of its kernel, memcpy and memset intervals over the segment's wall
time."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
