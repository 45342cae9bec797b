"""One reader a per-layer metric: ``read(ctx) -> number or None``.

``ctx`` holds the card's name (``kind``), the configuration, ``n_f``,
the problem's ``work`` module, the untraced window (``window_s``,
``units``, ``counts`` of loss evaluations by kind, and ``count_from``
and ``count_to``, the harness's two marks, each a ``harness.Mark`` of
the phase's ``totals()`` and the program's counters, between which the
counter readers read) and the traced segment (``trace``, a
``portbench.tracing.Trace``; ``traced_units``; ``traced_counts``).
A reader that finds nothing to read returns None, and the metric is
left out of the run's line."""
