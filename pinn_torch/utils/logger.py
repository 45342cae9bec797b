"""Training logger with the reference's exact line format.

Counterpart of ``pinn/utils/logger.py``: epoch lines every
``log_frequency`` epochs as

    tf_epoch =      0  elapsed = 00:12 (+0.1)  loss = 1.2345e+00

(``nt_epoch`` for L-BFGS iterations), the injected error metric at
train end, and ``hp["log_file"]`` JSON lines.  The header names the
torch version and the device where the JAX version named its backend.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import torch

from pinn_torch.device import DeviceLike, device_name, resolve_device


class Logger:
    def __init__(self, hp: dict, print_fn: Callable[[str], None] = print,
                 device: DeviceLike = None):
        self._print = print_fn
        self._print("Hyperparameters:")
        self._print(json.dumps({k: v for k, v in hp.items()}, indent=2))
        self._print("")
        dev = resolve_device(device)
        self._print(f"torch version: {torch.__version__}")
        self._print(f"Device: {dev}  ({device_name(dev)})")
        self._print(f"GPU-accelerated: {dev.type == 'cuda'}")

        self.start_time = time.time()
        self.prev_time = self.start_time
        self.frequency = hp.get("log_frequency", 10)
        self.error_fn: Optional[Callable[[], float]] = None
        self._log_path = hp.get("log_file")
        if self._log_path:
            self._jsonl({"event": "init", "hp": {
                k: v for k, v in hp.items() if _json_safe(v)}})

    def _jsonl(self, record: dict) -> None:
        if self._log_path:
            record.setdefault("t", round(time.time() - self.start_time, 3))
            with open(self._log_path, "a") as fh:
                fh.write(json.dumps(record) + "\n")

    def get_epoch_duration(self) -> str:
        now = time.time()
        edur = now - self.prev_time
        self.prev_time = now
        return f"{edur:04.1f}"[:4]

    def get_elapsed(self) -> str:
        elapsed = int(time.time() - self.start_time)
        return f"{elapsed // 60:02d}:{elapsed % 60:02d}"

    def get_error_u(self) -> float:
        if self.error_fn is None:
            return float("nan")
        return float(self.error_fn())

    def set_error_fn(self, error_fn: Callable[[], float]) -> None:
        self.error_fn = error_fn

    def log_train_start(self, model=None, model_description: bool = False) -> None:
        self._print("\nTraining started")
        self._print("================")
        self.model = model
        if model_description and hasattr(model, "summary"):
            self._print(model.summary())

    def log_train_epoch(self, epoch: int, loss, custom: str = "",
                        is_iter: bool = False) -> None:
        if epoch % self.frequency == 0:
            name = "nt_epoch" if is_iter else "tf_epoch"
            self._print(
                f"{name} = {epoch:6d}  "
                f"elapsed = {self.get_elapsed()} "
                f"(+{self.get_epoch_duration()})  "
                f"loss = {float(loss):.4e}  " + custom)
            self._jsonl({"event": "epoch", "phase": name, "epoch": epoch,
                         "loss": float(loss), "extra": custom or None})

    def log_train_opt(self, name: str) -> None:
        self._print(f"-- Starting {name} optimization --")

    def log_train_end(self, epoch: int, custom: str = "") -> None:
        self._print("==================")
        error = self.get_error_u()
        self._print(
            f"Training finished (epoch {epoch}): "
            f"duration = {self.get_elapsed()}  "
            f"error = {error:.4e}  " + custom)
        self._jsonl({"event": "end", "epoch": epoch, "error": error,
                     "extra": custom or None})


def _json_safe(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False
