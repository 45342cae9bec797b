"""The work of a fused tanh-MLP loss over Taylor streams: the value, the
x, xx and t streams through every layer, the head, and with gradients
the backward through all four streams.

Operations a point (float32 multiply-adds count 2):
- forward: 4 h1 for the first layer's value (the tangent rows are
  constant), 8 a b for each later a -> b layer (four streams), 12 for
  each hidden neuron's tanh and stream recombination;
- backward: 4 h1 for dW0 on the value stream, 16 a b for each later
  layer's dW and input adjoints, 40 for each hidden neuron's adjoint
  recombination and rematerialisation.
Bytes: the points and their ``n_aux`` rows read once, the weights read
once, the loss (and the gradients) written once.
"""

from __future__ import annotations

from typing import Sequence, Tuple

FWD_EW, BWD_EW = 12, 40


def cost(layers: Sequence[int], n: int, grads: bool,
         n_aux: int) -> Tuple[float, float]:
    """``(operations, bytes)`` of one evaluation over ``n`` points."""
    hidden, n_out = list(layers[1:-1]), layers[-1]
    pairs = list(zip(hidden[:-1], hidden[1:])) + [(hidden[-1], n_out)]
    ops = 4 * hidden[0] + sum(8 * a * b for a, b in pairs) + FWD_EW * sum(hidden)
    if grads:
        ops += (4 * hidden[0] + sum(16 * a * b for a, b in pairs)
                + BWD_EW * sum(hidden))
    n_weights = (sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
                 + 2 * hidden[0])
    n_bytes = 4 * ((2 + n_aux) * n + n_weights
                   + (1 + n_weights if grads else 1))
    return float(ops * n), float(n_bytes)
