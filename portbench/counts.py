"""The chip's peak and the arithmetic of the metrics.

Peak: NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
"""
from __future__ import annotations

BF16_FLOPS = 989e12          # dense bf16 tensor cores; the highest rate


def nearest_rank(xs, q: float) -> float:
    """The q-th percentile by nearest rank."""
    import math
    s = sorted(xs)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]
