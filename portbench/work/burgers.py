"""Burgers inference: the data and collocation points in one fused
stream, N_u + N_f points with three aux rows each (target, weight, data
flag), as ``chip_smoke._bound`` counts rows 1-2; and the bytes of the
sum of the kernel's partials, a row of ``1 + n_weights`` (loss and
gradients) or 1 (loss only) floats a 32-point tile, read once, and
its output written once."""

from portbench.work import fused_mlp

TILE = 32   # points a partials row


def cost(cfg: dict, n_f: int, grads: bool):
    return fused_mlp.cost(cfg["layers"], int(cfg["N_u"]) + n_f, grads, 3)


def reduce_bytes(cfg: dict, n_f: int, grads: bool) -> float:
    layers = cfg["layers"]
    n_weights = (sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
                 + 2 * layers[1])
    cols = 1 + n_weights if grads else 1
    rows = -(-(int(cfg["N_u"]) + n_f) // TILE)
    return float(4 * (rows * cols + cols))
