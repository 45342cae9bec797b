"""The benchmark's general generator: everything a run feeds the program
is drawn here from ``--seed``, on the card, in a few large calls.

- :func:`stream_seed` derives an independent seed for each named stream
  (the data subset, the collocation draw of each round, the weights)
  from the run's seed, which may be any whole number;
- :func:`collocation` draws a Latin-hypercube sample of the box
  [lb, ub], as pyDOE's ``lhs`` does (one uniform draw in each of n
  strata, the strata shuffled independently along each axis);
- :func:`glorot_weights` draws the initial weights of a tanh MLP:
  Glorot-normal (truncated to two standard deviations, rescaled to the
  std sqrt(2 / (fan_in + fan_out))), biases zero, in float32.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]   # the checkout

_TRUNC_STD = 0.87962566103423978   # std of N(0, 1) truncated to [-2, 2]


def stream_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream named by ``keys`` under ``seed``."""
    s = int(seed) % (1 << 64)
    words = [s & 0xFFFFFFFF, s >> 32]
    for key in keys:
        words += ([int(key)] if isinstance(key, int)
                  else list(str(key).encode()))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(device, seed: int, *keys) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *keys))
    return g


def collocation(lb, ub, n: int, seed: int, round_: int,
                device) -> torch.Tensor:
    """``n`` Latin-hypercube points of the box [lb, ub] (float32, (n, 2))
    for collocation round ``round_`` of the run ``seed``."""
    g = generator(device, seed, "collocation", round_)
    dims = len(lb)
    u = torch.rand((n, dims), generator=g, device=device, dtype=torch.float64)
    strata = torch.stack([torch.randperm(n, generator=g, device=device)
                          for _ in range(dims)], dim=1)
    unit = (strata.to(torch.float64) + u) / n
    lo = torch.as_tensor(np.asarray(lb, np.float64), device=device)
    hi = torch.as_tensor(np.asarray(ub, np.float64), device=device)
    return (lo + (hi - lo) * unit).to(torch.float32)


def glorot_weights(layers: Sequence[int], seed: int,
                   device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``[(W, b), ...]`` with W (fan_in, fan_out), float32, on ``device``."""
    pairs = list(zip(layers[:-1], layers[1:]))
    sizes = [a * b for a, b in pairs]
    lo, hi = (0.5 * (1.0 + math.erf(s / math.sqrt(2.0))) for s in (-2.0, 2.0))
    g = generator(device, seed, "weights")
    u = torch.empty(sum(sizes), device=device).uniform_(lo, hi, generator=g)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    scale = torch.cat([torch.full((s,), math.sqrt(2.0 / (a + b)) / _TRUNC_STD,
                                  device=device)
                       for s, (a, b) in zip(sizes, pairs)])
    flat = z * scale
    out = []
    for W, (a, b) in zip(torch.split(flat, sizes), pairs):
        out.append((W.reshape(a, b).clone(),
                    torch.zeros(b, device=device)))
    return out


def dataset(name: str) -> dict:
    """The arrays of a data file of the checkout (``data/...npz``)."""
    with np.load(ROOT / name, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}
