"""One reader a per-layer metric: ``read(ctx) -> number or None``.

``ctx`` holds the card's name (``kind``), the configuration, ``n_f``,
the problem's ``work`` module, the untraced window (``window_s``,
``units``, ``counts`` of loss evaluations by kind, the optimizer's own
``evals`` and ``iters``) and the traced segment (``trace``, a
``portbench.tracing.Trace``; ``traced_units``; ``traced_counts``).
A reader that finds nothing to read returns None, and the metric is
left out of the run's line."""
