"""The table of peaks the benchmark divides by: NVIDIA's published rates of
one H100 SXM (data sheet; dense, without sparsity, at the full 700 W power
limit). A card set below 700 W reads lower shares; every run records the
card's name and power limit beside its numbers.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "float32": 67e12,     # outside the tensor cores (TF32 off)
    "bfloat16": 989e12,   # tensor cores
    "int8": 1979e12,      # tensor cores
}


def bound_s(nbytes: float, ops: float, dtype: str) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take to move `nbytes` once and do `ops` operations of `dtype`."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
