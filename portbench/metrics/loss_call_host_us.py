"""The mean host time of one call of the program's loss, in us: the
program's span ``pinn_torch.loss`` (the fused wrapper's point prep,
tangent rows and launch, and Schrödinger's eager initial and boundary
terms), in the traced segment.  It reads the wrappers only where the
launch queue is empty when a call starts, as after each of L-BFGS's
host syncs; where the device paces a phase that never syncs (Adam at
a million points) the call blocks on a full queue and the span times
the kernel instead, so no such cell lists it."""

from portbench.metrics._program import span_mean_s


def read(ctx):
    seconds = span_mean_s(ctx, "loss")
    return None if seconds is None else 1e6 * seconds
