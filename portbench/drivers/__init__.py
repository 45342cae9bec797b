"""One module a phase of training: ``Phase(cell)`` drives the program's
optimizer over the cell's loss, composed as ``pinn_torch.train.Trainer``
composes it, in chunks of ``Trainer.CHUNK_CAP``.

A phase gives ``check_steps(n)`` (the first n steps, one call each,
and what the check compares: the losses, the first gradient as the
optimizer holds it, each leaf's change), ``warm()``, ``chunk() ->
(units done, losses or None)``, ``totals() -> (units, loss
evaluations)`` since the start; the module names ``RATES``, its
end-to-end rates, each a function of the window's units and loss
evaluations whose value over the window's seconds is the metric of
that name (a cell reports those of them it lists), ``REFERENCE``,
the module of ``portbench.reference`` that follows the same steps, and
``NUMBERS``, the judge's numbers the phase reads.  A phase whose
``NUMBERS`` take in the judge's late numbers also gives ``final()``,
its state where the window left it (``drivers/lbfgs.py`` says what)."""
