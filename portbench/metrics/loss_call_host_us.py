"""The mean host time of one call of the program's loss, in us: the
benchmark's span around each call, in the traced segment (the fused
wrapper's point prep, tangent rows and launch, and Schrödinger's eager
initial and boundary terms).  It reads the wrappers only where the
launch queue is empty when a call starts, as after each of L-BFGS's
host syncs; where the device paces a phase that never syncs (Adam at
a million points) the call blocks on a full queue and the span times
the kernel instead, so no such cell lists it."""

from portbench.tracing import SPAN_PREFIX


def read(ctx):
    if ctx.trace is None:
        return None
    calls = [d for name, ds in ctx.trace.spans.items()
             if name.startswith(SPAN_PREFIX) for d in ds]
    return 1e6 * sum(calls) / len(calls) if calls else None
