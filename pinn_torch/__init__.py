"""pinn_torch — the PyTorch/CUDA port of :mod:`pinn` for NVIDIA Hopper.

The JAX package ``pinn/`` is the reference; this package mirrors its
module layout (``pinn_torch.models.mlp`` is the counterpart of
``pinn.models.mlp``, and so on) so each ported function sits at the
same path as the function it replaces.

Importing the package is cheap: it imports ``torch`` and ``numpy``
only (never ``jax``), and no kernel is built until a CUDA tensor first
reaches one (``pinn_torch.ops._build``).

Ported so far: the continuous-time Burgers inference slice — data prep,
the tanh MLP with Taylor-mode streams, the eager loss, the fused
loss+gradient kernels in CUDA C++ (``pinn_torch/csrc/``), Adam, the
repo's own L-BFGS, the Trainer and ``experiments.inf_cont_burgers``.
"""

__version__ = "0.1.0"
