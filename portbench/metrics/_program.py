"""The program's own spans and counters (``pinn_torch.utils.trace``), as
a reader finds them after the run: the process-wide counters, and the
host seconds of each span entered while a profiler ran, which in a run
of the benchmark is the traced segment alone.

A program without that module (before it had spans) gives None, and so
does a run in which the device ran nothing (the harness's rehearsal on
the CPU, where the fused losses take their plain versions and a span
times the arithmetic itself): the metric is then left out of the line.
"""


def _module():
    try:
        from pinn_torch.utils import trace
    except ImportError:
        return None
    return trace


def _on_card(ctx) -> bool:
    return ctx.trace is not None and ctx.trace.busy_s > 0


def counter(ctx, name: str):
    """The counter ``name`` over the whole run, or None."""
    trace = _module()
    if trace is None or not _on_card(ctx):
        return None
    return trace.counters().get(name)


def span_mean_s(ctx, name: str):
    """The mean host seconds of the span ``name`` in the traced
    segment, or None."""
    trace = _module()
    if trace is None or not _on_card(ctx):
        return None
    calls, seconds = trace.span_totals().get(name, (0, 0.0))
    return seconds / calls if calls else None
