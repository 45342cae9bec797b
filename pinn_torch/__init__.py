"""pinn_torch — the PyTorch/CUDA port of :mod:`pinn` for NVIDIA Hopper.

The JAX package ``pinn/`` is the reference; this package mirrors its
module layout (``pinn_torch.models.mlp`` is the counterpart of
``pinn.models.mlp``, and so on) so each ported function sits at the
same path as the function it replaces.

The top-level names are the JAX package's (``pinn/__init__.py``):
``PhysicsInformedNN``, ``EnsemblePINN``, ``Trainer``, ``HP``,
``load_hp``, ``default_dtype``, ``set_default_dtype``, ``mlp`` and the
submodules ``data``, ``dtypes``, ``ensemble``, ``export``, ``irk``,
``optim``, ``parallel`` and ``problems``.  Importing the package is cheap: it
imports ``torch`` and ``numpy`` (never ``jax`` or ``matplotlib``), and
no kernel is built until a CUDA tensor first reaches one
(``pinn_torch.ops._build``).

Ported so far: data prep, the tanh MLP with Taylor-mode streams, the
continuous-time Burgers (inference with RAR, identification) and
Schrödinger families with their eager and fused losses, the
discrete-time IRK families, Navier–Stokes identification (with the jvp
oracles in ``pinn_torch.ops.diff``), the dataset generators
(``pinn_torch.datagen``), a counterpart of every TPU kernel in CUDA C++
(``pinn_torch/csrc/``), Adam, the repo's own L-BFGS, the Trainer, the
facade (``api``), ensembling, serving export, the experiments and
campaign recipes under ``pinn_torch.experiments`` (with the custom-PDE
example, the PINN-against-network comparisons and the figures of
``experiments.viz``, which import matplotlib only to draw) and the
command line ``python -m pinn_torch`` (``pinn_torch.cli``), and the
data-parallel tier (``pinn_torch.parallel``: meshes of shards, the
fixed-order reduction, ``torch.distributed`` meshes; the fused DP
losses; ``tpu_mesh``; ``pinn_torch.graft_entry``).
"""

__version__ = "0.1.0"

from pinn_torch import (data, dtypes, ensemble, export, irk, optim,  # noqa: E402,F401
                        parallel, problems)
from pinn_torch.api import PhysicsInformedNN  # noqa: E402,F401
from pinn_torch.dtypes import default_dtype, set_default_dtype  # noqa: E402,F401
from pinn_torch.ensemble import EnsemblePINN  # noqa: E402,F401
from pinn_torch.models import mlp  # noqa: E402,F401
from pinn_torch.train import Trainer  # noqa: E402,F401
from pinn_torch.utils.config import HP, load_hp  # noqa: E402,F401
