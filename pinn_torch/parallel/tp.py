"""The tensor-parallel MLP layer: one layer applied to a set of streams
over a mesh row's model shards.

JAX has no counterpart file: with ``shard_params_tp``'s placement GSPMD
splits each product and inserts the ``psum``.  Here
:func:`linear` does it for one layer, for every stream that goes
through it (the value and the Taylor derivative streams), and the
forwards in ``pinn_torch.models.mlp`` and
``pinn_torch.problems.navierstokes`` apply their tanh rules shard by
shard in between (:func:`map_shards`).

A stream is a list of tensors: one when it is whole (on the row's first
model device), or one a model shard, in shard order, each holding its
slice of the features on its shard's device.  By the layer's kind
(``TPParams.kind``):

- column: each shard multiplies the whole input by its column slice of
  W and adds its slice of b; the output is sharded by feature;
- row: each shard multiplies its feature slice of the input (cut here
  if the input is whole) by its row slice of W; the partial products
  are summed left to right in shard order on the first device, then b
  is added once; the output is whole;
- replicated: a sharded input is gathered (concatenated in shard
  order), then the whole product.

The bias goes to the first stream only (the value; a derivative stream
has none).  The sums have a fixed order, with no ``all_reduce`` and no
atomics, so two calls are bitwise equal.  Autograd carries the
gradients back through the slices and the device copies; the slices are
disjoint, so a full leaf's gradient is exact.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from pinn_torch.parallel.dp import _fold

Stream = Optional[List[torch.Tensor]]


def weight_parts(w: torch.Tensor, kind: str,
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """W's column (``"column"``) or row (``"row"``) slices, one a shard
    on its device, or the whole W on the first device."""
    n = len(devices)
    if kind == "column":
        c = w.shape[1] // n
        return [w[:, i * c:(i + 1) * c].to(d) for i, d in enumerate(devices)]
    if kind == "row":
        r = w.shape[0] // n
        return [w[i * r:(i + 1) * r].to(d) for i, d in enumerate(devices)]
    return [w.to(devices[0])]


def gather(stream: Stream, devices: Sequence[torch.device]):
    """The whole stream: its parts concatenated in shard order along the
    feature axis on the first device."""
    if stream is None or len(stream) == 1:
        return None if stream is None else stream[0]
    return torch.cat([p.to(devices[0]) for p in stream], dim=-1)


def linear(xs: Sequence[Stream], w: torch.Tensor, b: torch.Tensor,
           kind: str, devices: Sequence[torch.device],
           mm: Callable) -> List[Stream]:
    """``x @ W`` for each stream of ``xs`` (``+ b`` for the first) by the
    layer's ``kind``, as the module's docstring says; ``mm`` is the
    product (``pinn_torch.models.mlp._mm``, which promotes as JAX
    does)."""
    n, d0 = len(devices), devices[0]
    ws = weight_parts(w, kind, devices)
    out: List[Stream] = []
    for k, x in enumerate(xs):
        if x is None:
            out.append(None)
        elif kind == "column":
            whole = gather(x, devices)
            parts = [mm(whole.to(d), wp) for d, wp in zip(devices, ws)]
            if k == 0:
                c = w.shape[1] // n
                parts = [p + b[i * c:(i + 1) * c].to(d)
                         for i, (p, d) in enumerate(zip(parts, devices))]
            out.append(parts)
        elif kind == "row":
            r = w.shape[0] // n
            cut = x if len(x) == n else \
                [x[0][..., i * r:(i + 1) * r] for i in range(n)]
            z = _fold([mm(p.to(d), wp)
                       for p, d, wp in zip(cut, devices, ws)])
            out.append([z + b.to(d0) if k == 0 else z])
        else:
            z = mm(gather(x, devices), ws[0])
            out.append([z + b.to(d0) if k == 0 else z])
    return out


def map_shards(fn: Callable, streams: Sequence[Stream]) -> List[Stream]:
    """``fn`` (elementwise rules, a tuple out) applied to each shard's
    parts of ``streams``; its outputs regrouped into streams.  The
    streams given are all whole or all sharded alike (one layer's
    outputs)."""
    n = max(len(s) for s in streams if s is not None)
    outs = [fn(*(None if s is None else s[i] for s in streams))
            for i in range(n)]
    return [None if first is None else [o[k] for o in outs]
            for k, first in enumerate(outs[0])]
