"""Quantization: float params → int8/int16/int32 engine arithmetic domain.

The port's own copy of `nnue_vision_tpu/quantize.py` (numpy only), so that
the port imports nothing of the JAX package.

Matches the reference scheme exactly (serialize.py:210-239): a single
uniform scale of 64.0 everywhere, weights `int8 = round(w*64) clamp ±127`,
biases `int32 = round(b*64)` (no clamp). Rounding is round-half-to-even —
np.round — matching torch.round used by the reference writer, so files are
byte-identical for identical float weights.

Also hosts the truncating integer division used throughout the engine
(`acc / static_cast<int32_t>(scale)` in C++ truncates toward zero, unlike
numpy/JAX floor division) and weight clipping.
"""

from __future__ import annotations

import numpy as np

QUANT_SCALE = 64.0
QUANTIZED_ONE = 127.0


def quantize_weight_i8(w: np.ndarray, scale: float = QUANT_SCALE) -> np.ndarray:
    """`round(w*scale)` (half-to-even) clamped to ±127, as int8."""
    return np.clip(np.round(np.asarray(w, np.float64) * scale), -127, 127).astype(
        np.int8
    )


def quantize_bias_i32(b: np.ndarray, scale: float = QUANT_SCALE) -> np.ndarray:
    """`round(b*scale)` (half-to-even), as int32 — no clamp, like the reference."""
    return np.round(np.asarray(b, np.float64) * scale).astype(np.int32)


def clip_unit(w: np.ndarray) -> np.ndarray:
    """Pre-quantization weight clipping to [-1, 1] (nnue.py:528-539)."""
    return np.clip(w, -1.0, 1.0)


def trunc_div(a, b):
    """C-style integer division: truncate toward zero.

    The engine divides int32 accumulators by int32(scale) with C `/`, which
    truncates toward zero; numpy's `//` floors. Works on numpy arrays and
    scalars of integer dtype. `b` must be positive.
    """
    a = np.asarray(a)
    q = np.abs(a) // b
    return np.where(a < 0, -q, q).astype(a.dtype)
