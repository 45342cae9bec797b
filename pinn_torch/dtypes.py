"""Precision policy.

Counterpart of ``pinn/dtypes.py``: the port's default floating dtype is
float32, and float64 is an opt-in parity mode, through
:func:`set_default_dtype` or the ``PINN_X64=1`` environment variable.
PyTorch has float64 everywhere, so there is no x64 switch to flip; the
H100 runs float64 natively.
"""

from __future__ import annotations

import os

import torch

_DEFAULT = torch.float64 if os.environ.get("PINN_X64") == "1" else torch.float32


def default_dtype() -> torch.dtype:
    """The framework-wide default floating dtype."""
    return _DEFAULT


def set_default_dtype(dtype) -> None:
    """Set the framework-wide default floating dtype (``torch.float32``
    or ``torch.float64``, or their names)."""
    global _DEFAULT
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the default dtype is float32 or float64, got {dtype}")
    _DEFAULT = dtype


def to_numpy(t: torch.Tensor):
    """``t`` as a numpy array on the host.  numpy has no bfloat16, so a
    bf16 tensor widens to float32, which is exact."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
