"""Device resolution: the caller names the device, this module checks it.

``resolve_device("cuda")`` raises when no CUDA device is present — a run
asked to use the card never continues on the CPU.  ``None`` picks the
card when there is one and the CPU otherwise; the Logger prints which
one was taken.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was requested but torch reports no "
                f"CUDA device (torch {torch.__version__}, "
                f"built for CUDA {torch.version.cuda})")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} was requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are present")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(the port runs on 'cuda' or 'cpu')")
    return dev


def device_name(device: Optional[torch.device]) -> str:
    """Human-readable name of ``device`` for log lines."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
