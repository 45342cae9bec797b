"""One module a configuration's ``problem``: its inputs drawn from the
seed, its constants, and the program's loss over them.

Each module gives ``make(cfg, n_f, seed, device) -> (batch, const)``,
with ``batch`` the dict of float32 tensors the program's loss and the
reference both take and ``const`` the domain and coefficients, and
``program_loss(cfg, const)``, the program's loss for that batch.  The
reference module of the same name (``portbench.reference``) computes
the same loss from the same batch.
"""
