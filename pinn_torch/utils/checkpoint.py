"""npz checkpoints in the JAX package's file format.

Counterpart of ``pinn/utils/checkpoint.py`` (``save_npz``/``load_npz``/
``save_npz_atomic``/``resume_meta``): one compressed npz holding the
flat parameter vector (``pinn_torch.params`` order: W0, b0, W1, b1, ..., then any
tail leaves such as ``IdeParams``' ``lambda1``, ``log_lambda2``) and a
JSON ``meta`` with the leaf shapes, the hp dict and any extra
metadata.  A file written by either package loads in the other.

:func:`params_from_numpy` is how parameters cross from JAX: a list of
``(W, b)`` numpy arrays (``np.asarray`` of each JAX leaf) becomes a
list of torch tensors on the named device and dtype;
:func:`ide_params_from_numpy` does the same for identification
parameters ``(net_pairs, lambda1, log_lambda2)`` and
:func:`ns_ide_params_from_numpy` for the Navier–Stokes ones
``(net_pairs, lambda1, lambda2)``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from pinn_torch import params as pcodec
from pinn_torch.device import DeviceLike, resolve_device
from pinn_torch.dtypes import to_numpy


def params_from_numpy(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                      device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32) -> pcodec.Params:
    """``[(W, b), ...]`` numpy arrays -> the same pairs as tensors."""
    dev = resolve_device(device)
    # np.array copies, so the tensors never share memory with the caller's
    # (possibly read-only) arrays.
    return [(torch.as_tensor(np.array(w), dtype=dtype, device=dev),
             torch.as_tensor(np.array(b), dtype=dtype, device=dev))
            for w, b in pairs]


def ide_params_from_numpy(net_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                          lambda1: np.ndarray, log_lambda2: np.ndarray,
                          device: DeviceLike = None,
                          dtype: torch.dtype = torch.float32):
    """JAX ``IdeParams`` leaves as numpy -> the port's ``IdeParams``."""
    from pinn_torch.problems.burgers import IdeParams

    dev = resolve_device(device)
    return IdeParams(net=params_from_numpy(net_pairs, dev, dtype),
                     lambda1=_vec(lambda1, dev, dtype),
                     log_lambda2=_vec(log_lambda2, dev, dtype))


def ns_ide_params_from_numpy(net_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                             lambda1: np.ndarray, lambda2: np.ndarray,
                             device: DeviceLike = None,
                             dtype: torch.dtype = torch.float32):
    """JAX ``NSIdeParams`` leaves as numpy -> the port's ``NSIdeParams``."""
    from pinn_torch.problems.navierstokes import NSIdeParams

    dev = resolve_device(device)
    return NSIdeParams(net=params_from_numpy(net_pairs, dev, dtype),
                       lambda1=_vec(lambda1, dev, dtype),
                       lambda2=_vec(lambda2, dev, dtype))


def _vec(a, device, dtype) -> torch.Tensor:
    """A scalar leaf as a (1,) tensor, like the JAX leaves."""
    return torch.as_tensor(np.array(a).reshape(1), dtype=dtype, device=device)


def save_npz(path: str, params: Any, hp: Optional[dict] = None,
             extra: Optional[dict] = None) -> None:
    """Flat-vector checkpoint (layout = the reference codec order).
    bfloat16 parameters are written as float32 (exact; numpy has no
    bfloat16), which :func:`load_npz` casts back to the template's
    dtype."""
    with torch.no_grad():
        flat = to_numpy(pcodec.ravel(params))
    shapes = [list(a.shape) for a in pcodec.leaves(params)]
    meta = {"shapes": shapes, "hp": hp or {}, "extra": extra or {}}
    np.savez_compressed(path, flat=flat, meta=json.dumps(meta))


def load_npz(path: str, like: Any = None) -> Tuple[Any, dict]:
    """Returns ``(params, meta)``.

    With ``like`` (any parameter structure: ``(W, b)`` pairs,
    ``IdeParams``) the flat vector is unraveled into that structure,
    each leaf with the dtype and device of ``like``'s leaf; otherwise a
    flat list of numpy arrays with the stored shapes comes back (W0,
    b0, W1, b1, ...), as in the JAX package.
    """
    with np.load(path, allow_pickle=False) as d:
        flat = d["flat"]
        meta = json.loads(str(d["meta"]))
    if flat.dtype == np.dtype("V2"):
        # The JAX package's bfloat16 checkpoint: raw bf16 bit patterns,
        # each the top half of a float32's.
        flat = (flat.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    if like is not None:
        tmpl = pcodec.leaves(like)
        if flat.size != sum(a.numel() for a in tmpl):
            raise ValueError(f"{path} holds {flat.size} parameters; the "
                             f"template has {pcodec.num_params(like)}")
        parts = pcodec.leaves(pcodec.make_unravel(like)(torch.as_tensor(flat)))
        return pcodec.rebuild(like, [
            p.to(dtype=a.dtype, device=a.device, copy=True)
            for p, a in zip(parts, tmpl)]), meta
    out, off = [], 0
    for shape in meta["shapes"]:
        size = int(np.prod(shape)) if shape else 1
        out.append(flat[off:off + size].reshape(shape))
        off += size
    return out, meta


def save_npz_atomic(path: str, params: Any, hp: Optional[dict] = None,
                    extra: Optional[dict] = None) -> str:
    """Crash-safe :func:`save_npz`: write a sibling temp file, then
    ``os.replace`` it into place.  Returns the final path (``.npz``
    appended if missing, as ``np.savez`` does)."""
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp.npz"
    save_npz(tmp, params, hp=hp, extra=extra)
    os.replace(tmp, final)
    return final


def resume_meta(path: str) -> dict:
    """The ``extra`` metadata of a checkpoint (phase and epoch for the
    Trainer's periodic ``save_every`` saves) without the weights."""
    with np.load(path, allow_pickle=False) as d:
        return json.loads(str(d["meta"])).get("extra", {})
