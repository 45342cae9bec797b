"""pinn_torch — the PyTorch/CUDA port of :mod:`pinn` for NVIDIA Hopper.

The JAX package ``pinn/`` is the reference; this package mirrors its
module layout (``pinn_torch.models.mlp`` is the counterpart of
``pinn.models.mlp``, and so on) so each ported function sits at the
same path as the function it replaces.

Importing the package is cheap: it imports ``torch`` and ``numpy``
only (never ``jax``), and no kernel is built until a CUDA tensor first
reaches one (``pinn_torch.ops._build``).

Ported so far: data prep, the tanh MLP with Taylor-mode streams, the
continuous-time Burgers (inference with RAR, identification) and
Schrödinger families with their eager and fused losses, the
discrete-time IRK families, Navier–Stokes identification (with the
dataset generators in ``pinn_torch.datagen`` and the jvp oracles in
``pinn_torch.ops.diff``), a counterpart of every TPU kernel in CUDA C++
(``pinn_torch/csrc/``), Adam, the repo's own L-BFGS, the Trainer, the
facade (``api``), ensembling, serving export, the experiments and
campaign recipes under ``pinn_torch.experiments`` and the command line
``python -m pinn_torch`` (``pinn_torch.cli``).
"""

__version__ = "0.1.0"
