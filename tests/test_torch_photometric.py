"""The plain version of the photometric kernel (K5) held against the JAX
package on the same drawn parameters and noise: against
`photometric_block(interpret=True)` for both variants, and against the JAX
package's unfused op chain (its `_apply_*` helpers, and its bc, blur,
noise, fog, posterize and equalize written as those ops compute them).

Tolerance: atol 2e-6, the JAX package's own bound between its fused and
unfused chains (the blur sums its 3×3 window in another order; XLA may
contract a multiply-add). The port's unfused chain (the blur as one
depthwise conv) agrees with its plain version to the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.data import augment as A
from nnue_vision_tpu.ops import photometric_kernel as jpk
from nnue_vision_tpu_torch.ops import photometric_kernel as tpk

GATES = {"medium": (0, 3, 7, 8, 10, 11, 15, 20, 22, 23),
         "heavy_extra": (0, 3, 7, 8, 10, 11)}


def _draws(variant, b, h, w, seed, gates="drawn"):
    """x, noise, fparams, iparams in the kernel layout, and the shadow's
    angle (its cos and sin are fparams columns, as the JAX package packs
    them); numpy draws, `gates` "drawn" (p .5 each), "on" or "off"."""
    rng = np.random.default_rng(seed)
    theta = jnp.asarray(rng.uniform(0, 2 * np.pi, b).astype(np.float32))
    nf, ni = tpk.VARIANTS[variant]
    f = np.zeros((b, nf), np.float32)
    f[:, 1] = rng.uniform(-0.3, 0.3, b)                 # bright
    f[:, 2] = 1 + rng.uniform(-0.3, 0.3, b)             # contrast
    f[:, 4] = rng.uniform(-15 / 255, 15 / 255, b)       # hue
    f[:, 5] = 1 + rng.uniform(-0.2, 0.2, b)             # sat
    f[:, 6] = 1 + rng.uniform(-0.2, 0.2, b)             # val
    f[:, 9] = rng.uniform(0.01, 0.1, b)                 # sigma
    if variant == "medium":
        f[:, 12] = rng.uniform(-8 / 255, 8 / 255, b)
        f[:, 13] = 1 + rng.uniform(-0.1, 0.1, b)
        f[:, 14] = 1 + rng.uniform(-0.1, 0.1, b)
        f[:, 16], f[:, 17] = np.asarray(jnp.cos(theta)), np.asarray(jnp.sin(theta))
        f[:, 18] = rng.uniform(-0.3, 0.3, b)            # offset
        f[:, 19] = rng.uniform(0.4, 0.7, b)             # dark
        f[:, 21] = rng.uniform(0.1, 0.4, b)             # fog amount
    g = list(GATES[variant])
    f[:, g] = {"on": 1.0, "off": 0.0}.get(
        gates, (rng.random((b, len(g))) < 0.5).astype(np.float32))
    i = np.zeros((b, ni), np.int32)
    for r in range(ni // 4):
        frac = rng.uniform(0.1, 0.25, b)
        hh = np.maximum(1, (frac * h).astype(np.int32))
        ww = np.maximum(1, (frac * w).astype(np.int32))
        i[:, 4 * r:4 * r + 4] = np.stack([
            (rng.random(b) * (h - hh)).astype(np.int32), hh,
            (rng.random(b) * (w - ww)).astype(np.int32), ww], 1)
    x = rng.random((b, h, w, 3), dtype=np.float32)
    noise = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    return x, noise, f, i, theta


def _port(fn, x, noise, f, i, variant):
    return fn(*(torch.from_numpy(a) for a in (x, noise, f, i)),
              variant=variant).numpy()


def _jax_unfused(x, noise, f, i, theta, variant):
    """The JAX package's unfused chain (data/augment.py:487-637) on given
    parameters."""
    b = x.shape[0]
    x, noise = jnp.asarray(x), jnp.asarray(noise)

    def P(k):
        return jnp.asarray(f[:, k]).reshape(b, 1, 1, 1)

    def G(k):
        return P(k) > 0.5

    def rect(j):
        return tuple(jnp.asarray(i[:, j + k]) for k in range(4))

    x = jnp.where(G(0), jnp.clip((x - 0.5) * P(2) + 0.5 + P(1), 0.0, 1.0), x)
    x = A._apply_hsv(x, G(3), P(4), P(5), P(6))
    kern = jnp.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], jnp.float32) / 16.0
    blurred = jax.lax.conv_general_dilated(
        x, jnp.tile(kern[:, :, None, None], (1, 1, 1, 3)), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=3)
    x = jnp.where(G(7), blurred, x)
    x = jnp.where(G(8), jnp.clip(x + noise * P(9), 0.0, 1.0), x)
    x = A._apply_cutout(x, G(10), *rect(0))
    if variant == "medium":
        x = A._apply_hsv(x, G(11), P(12), P(13), P(14))
        x = A._apply_shadow(x, G(15), theta.reshape(b, 1, 1),
                            jnp.asarray(f[:, 18]).reshape(b, 1, 1), P(19))
        x = jnp.where(G(20), x * (1.0 - P(21)) + P(21), x)
        x = jnp.where(G(22), jnp.round(x * 15.0) / 15.0, x)
        lo = x.min(axis=(1, 2, 3), keepdims=True)
        hi = x.max(axis=(1, 2, 3), keepdims=True)
        x = jnp.where(G(23), (x - lo) / jnp.maximum(hi - lo, 1e-6), x)
    else:
        x = A._apply_cutout(x, G(11), *rect(4))
    return np.asarray(x)


@pytest.mark.parametrize("gates", ["drawn", "on", "off"])
@pytest.mark.parametrize("variant", ["medium", "heavy_extra"])
def test_plain_matches_pallas(variant, gates):
    x, noise, f, i, _ = _draws(variant, 12, 32, 32, seed=len(gates), gates=gates)
    want = np.asarray(jpk.photometric_block(
        *(jnp.asarray(a) for a in (x, noise, f, i)), variant=variant,
        interpret=True))
    got = _port(tpk.photometric_block, x, noise, f, i, variant)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    if gates == "off":
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("variant", ["medium", "heavy_extra"])
@pytest.mark.parametrize("size", [32, 16, 64, (40, 48)])
def test_plain_matches_jax_unfused_chain(variant, size):
    """At 32×32 and below, and at the sizes where the JAX package runs its
    unfused chain and the card the band path (64×64, non-square 40×48)."""
    h, w = (size, size) if isinstance(size, int) else size
    x, noise, f, i, theta = _draws(variant, 10, h, w,
                                   seed=h if h == w else h + w)
    got = _port(tpk.photometric_block, x, noise, f, i, variant)
    want = _jax_unfused(x, noise, f, i, theta, variant)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(_port(tpk.photometric_unfused, x, noise, f, i, variant),
                               got, rtol=0, atol=2e-6)


def test_shape_checks():
    x, noise, f, i = (torch.from_numpy(a) for a in _draws("medium", 2, 8, 8, 0)[:4])
    with pytest.raises(ValueError, match="variant"):
        tpk.photometric_block(x, noise, f, i, variant="light")
    with pytest.raises(ValueError, match="fparams"):
        tpk.photometric_block(x, noise, f[:, :12], i, variant="medium")
    with pytest.raises(ValueError, match="H, W >= 3"):
        tpk.photometric_block(x[:, :2], noise[:, :2], f, i, variant="medium")
