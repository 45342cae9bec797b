"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's H100 SXM data sheet,
dense rates at the 700 W limit."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,        # float32 outside the tensor cores
        "hbm_bytes": 3.35e12,      # bytes/s
    },
}


def bound_s(kind: str, operations: float, n_bytes: float):
    """The least seconds of ``operations`` float32 operations and
    ``n_bytes`` of memory traffic on the card ``kind``; None for a card
    the table does not hold."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(operations / peak["f32_flops"], n_bytes / peak["hbm_bytes"])
