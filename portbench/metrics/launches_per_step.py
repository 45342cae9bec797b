"""Kernel launches a unit (step or iteration) in the traced segment:
the kernels the device ran, one a launch, over the units."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_units or not ctx.trace.n_kernels:
        return None
    return ctx.trace.n_kernels / ctx.traced_units
