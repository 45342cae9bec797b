"""Device resolution: the caller names the device, this module checks it.

The port runs on the card.  ``resolve_device(None)`` and
``resolve_device("cuda")`` give a CUDA device and raise when there is
none, so an entry point left without a device never carries on on the
CPU.  The CPU is taken only when the caller names it (``"cpu"``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            what = "the default device 'cuda'" if device is None else \
                f"device {str(dev)!r}"
            raise RuntimeError(
                f"{what} was requested but torch reports no CUDA device "
                f"(torch {torch.__version__}, built for CUDA "
                f"{torch.version.cuda}); pass device='cpu' for the CPU")
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
