"""The mean host time of the Schrödinger loss's eager initial and
boundary terms, in us: the program's span ``pinn_torch.loss.ic_bc``
(``pinn_torch/ops/fused_schrodinger.py``, 150 points through the eager
net and its Taylor streams), in the traced segment.  It reads the
wrapper only where the launch queue is empty when a loss call starts,
as after each of L-BFGS's host syncs.  Adam never syncs: at a million
points the device paces it, the queue fills and a launch blocks, so
the span would time the kernel ahead of it, as
``loss_call_host_us.adam`` did (dropped for that); no Adam cell lists
it."""

from portbench.metrics._program import span_mean_s


def read(ctx):
    seconds = span_mean_s(ctx, "loss.ic_bc")
    return None if seconds is None else 1e6 * seconds
