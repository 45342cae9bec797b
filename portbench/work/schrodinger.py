"""Schrödinger inference: the residual over the N_f collocation points
(the initial and boundary terms, 150 points, are not counted)."""

from portbench.work import fused_mlp


def cost(cfg: dict, n_f: int, grads: bool):
    return fused_mlp.cost(cfg["layers"], n_f, grads, 0)
