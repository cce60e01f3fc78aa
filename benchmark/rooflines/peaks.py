"""The H100 SXM data-sheet peaks the rooflines are taken against (dense,
without sparsity, at the full 700 W power limit; the result line's device
name and PERF.md give the card and its limit)."""

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores


def bound_s(n_bytes, n_flops):
    """The least time: the larger of bytes over bandwidth and operations
    over the float32 peak."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_F32_FLOPS)
