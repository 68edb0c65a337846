"""The plain version of the warp kernel (K4) held against the JAX package on
the same maps: `warp_coefficients`, one `lerp_pass`, the whole two-pass
warp against `warp_bilinear(interpret=True)` and against the one-hot-matmul
`_warp`, and the exactness the augmentation tiers rely on (rot90, flips and
integer translations reproduce the input bits; a map entirely out of frame
gives zeros).

Tolerance: atol 1e-5 for fractional maps, the JAX package's own bound
between its two realizations (constant terms fold in another order); 2e-6
for one pass on the same coefficients (XLA may contract a multiply-add);
exact for the exact-grid maps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.data import augment as A
from nnue_vision_tpu.ops import warp_kernel as jwarp
from nnue_vision_tpu_torch.ops import warp_kernel as twarp

H = 32


def _conformal(seed, b, h=H):
    """The heavy tier's geometric draws composed by the JAX package."""
    ks = list(jax.random.split(jax.random.PRNGKey(seed), 4))
    mv = A._geom_hflip(ks[0], b, 0.5)
    mv = A._mv_compose(mv, A._geom_rot90(ks[1], b, 0.5))
    mv = A._mv_compose(mv, A._geom_affine(ks[2], b, 0.3, 25.0, 0.1, (0.85, 1.15), h, h))
    mv = A._mv_compose(mv, A._geom_affine(ks[3], b, 0.3, 15.0, 0.1, (0.9, 1.1), h, h))
    return np.array(mv[0]), np.array(mv[1])


def _images(b, h=H, seed=0):
    return np.random.default_rng(seed).random((b, h, h, 3), dtype=np.float32)


def _port_warp(x, m, v):
    h, w = x.shape[1:3]
    params = twarp.pack_warp_params(*twarp.warp_coefficients(
        torch.from_numpy(m), torch.from_numpy(v), h, w))
    return twarp.warp_bilinear(torch.from_numpy(x), params).numpy()


def _matmul_warp(x, mv):
    old = A._WARP_IMPL
    A._WARP_IMPL = "matmul"
    try:
        return np.asarray(A._warp(jnp.asarray(x), mv))
    finally:
        A._WARP_IMPL = old


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coefficients_match_jax(seed):
    m, v = _conformal(seed, 64)
    swap, c1, c2 = jwarp.warp_coefficients(jnp.asarray(m), jnp.asarray(v), H, H)
    tswap, t1, t2 = twarp.warp_coefficients(torch.from_numpy(m),
                                            torch.from_numpy(v), H, H)
    np.testing.assert_array_equal(tswap.numpy(), np.asarray(swap))
    np.testing.assert_allclose(t1.numpy(), np.asarray(c1), rtol=0, atol=2e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(c2), rtol=0, atol=2e-6)
    p = twarp.pack_warp_params(tswap, t1, t2)
    assert p.shape == (64, twarp.PARAMS) and p.dtype == torch.float32


def test_lerp_pass_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.random((8, 16, 16 * 3), dtype=np.float32)
    coef = np.stack([rng.uniform(-0.4, 0.4, 8), rng.uniform(0.7, 1.3, 8),
                     rng.uniform(-4, 4, 8)], 1).astype(np.float32)
    want = np.asarray(jwarp.lerp_pass(jnp.asarray(x), jnp.asarray(coef), n=16,
                                      c=3, interpret=True))
    got = twarp.lerp_pass_reference(torch.from_numpy(x), torch.from_numpy(coef),
                                    n=16, c=3).numpy()
    # XLA may contract the position's multiply-add into an FMA
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_and_matmul(seed):
    b = 16
    x = _images(b, seed=seed + 10)
    m, v = _conformal(seed, b)
    mv = (jnp.asarray(m), jnp.asarray(v))
    got = _port_warp(x, m, v)
    want = np.asarray(jwarp.warp_bilinear(jnp.asarray(x), mv, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, _matmul_warp(x, mv), rtol=0, atol=1e-5)


def test_exact_grid_maps():
    """rot90 k = 0..3, hflip, and integer translations (zero fill where the
    shifted image leaves the frame) reproduce the input bits."""
    b = 4
    x = _images(b, seed=5)
    mats = [[[1.0, 0.0], [0.0, 1.0]], [[0.0, 1.0], [-1.0, 0.0]],
            [[-1.0, 0.0], [0.0, -1.0]], [[0.0, -1.0], [1.0, 0.0]]]
    zero = np.zeros((b, 2), np.float32)
    for k, mk in enumerate(mats):
        m = np.tile(np.asarray(mk, np.float32), (b, 1, 1))
        np.testing.assert_array_equal(_port_warp(x, m, zero),
                                      np.rot90(x, k, (1, 2)), err_msg=f"k={k}")
    flip = np.tile(np.asarray([[1.0, 0.0], [0.0, -1.0]], np.float32), (b, 1, 1))
    np.testing.assert_array_equal(_port_warp(x, flip, zero), x[:, :, ::-1])
    eye = np.tile(np.eye(2, dtype=np.float32), (b, 1, 1))
    shift = np.tile(np.asarray([[3.0, -5.0]], np.float32), (b, 1))
    want = np.zeros_like(x)
    want[:, :H - 3, 5:] = x[:, 3:, :H - 5]   # out(y, x) = in(y + 3, x - 5)
    np.testing.assert_array_equal(_port_warp(x, eye, shift), want)


def test_out_of_frame_is_zero():
    b = 3
    x = _images(b, seed=6)
    eye = np.tile(np.eye(2, dtype=np.float32), (b, 1, 1))
    for shift in ((100.0, 0.0), (0.0, -64.0), (40.0, 40.0)):
        v = np.tile(np.asarray([shift], np.float32), (b, 1))
        out = _port_warp(x, eye, v)
        np.testing.assert_array_equal(out, np.zeros_like(x))
        np.testing.assert_array_equal(
            np.asarray(jwarp.warp_bilinear(jnp.asarray(x), (jnp.asarray(eye),
                                                            jnp.asarray(v)),
                                           interpret=True)), out)


def test_shape_checks():
    x = torch.zeros((2, 16, 8, 3))
    with pytest.raises(ValueError, match="square"):
        twarp.warp_bilinear(x, torch.zeros((2, twarp.PARAMS)))
    with pytest.raises(ValueError, match="params"):
        twarp.warp_bilinear(torch.zeros((2, 8, 8, 3)), torch.zeros((3, twarp.PARAMS)))
