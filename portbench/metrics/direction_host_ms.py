"""The mean host time of one L-BFGS direction, in ms: the program's span
``pinn_torch.lbfgs.direction`` (the two-loop over the history ring:
at a full ring of 50 pairs, hundreds of small float64 launches), in the
traced segment.  The descent test that follows it syncs, so each direction
starts on an empty launch queue and the span times the host's
launches, not the device."""

from portbench.metrics._program import span_mean_s


def read(ctx):
    seconds = span_mean_s(ctx, "lbfgs.direction")
    return None if seconds is None else 1e3 * seconds
