"""The plain reference of the benchmark's cells.

Plain PyTorch, written from the published equations and the optimizers'
definitions: the tanh MLP with its input derivatives carried forward
(``mlp``), the PINN loss (``schrodinger``), Adam
(``adam``) and the L-BFGS variant that the configurations name
(``lbfgs``).  It imports nothing of the program under test and takes
nothing the program made: the harness hands it the same seeded inputs
and initial weights that it hands the program.

Each computation takes a :class:`precision.Precision`: ``FLOAT64`` is
the reference itself, ``TF32`` the control (float32 with the operands
of every matrix product rounded to TF32, the nearest precision below
the configurations' IEEE float32).
"""
