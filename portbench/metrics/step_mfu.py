"""The whole step's share of the card's float32 peak, in %: the
operations of the untraced window's loss evaluations over the window's
wall seconds times the peak."""

from portbench.metrics._work import evaluations
from portbench.peaks import PEAKS


def read(ctx):
    if ctx.kind not in PEAKS or not ctx.counts or ctx.window_s <= 0:
        return None
    ops = evaluations(ctx, ctx.counts)[0]
    return 100.0 * ops / (ctx.window_s * PEAKS[ctx.kind]["f32_flops"])
