"""The port's light input pipeline held against the JAX package's: the
plain version of K3 (`fused_light_pipeline` on CPU tensors) against JAX's
Pallas kernel in interpret mode and its pure-jnp oracle, on identical
numpy-made indices and parameters; identity parameters; the draws'
distributions; the light tier of `augment_batch`.

Tolerance: the port's plain version rounds the product x·α before adding
β, as eager torch and the JAX oracle do, so it equals the oracle exactly.
JAX's jitted interpret path may contract x·α + β into an FMA: against it,
samples with α = 1 are exact and the others within atol 1e-6 (one ulp of
the normalized value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.data import augment as jaug
from nnue_vision_tpu.ops import input_pipeline as jip
from nnue_vision_tpu_torch.data import augment as taug
from nnue_vision_tpu_torch.ops import input_pipeline as tip


def _images(n, h, w, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3), np.float32)


def _numpy_params(rng, batch, h, w):
    """Light-tier parameters with every branch present: flips, α ≠ 1 and
    holes on about half the samples each."""
    flip = rng.random(batch) < 0.5
    bc = rng.random(batch) < 0.5
    contr = 1.0 + rng.uniform(-0.1, 0.1, batch)
    bright = rng.uniform(-0.1, 0.1, batch)
    pf = np.stack([np.where(bc, contr, 1.0),
                   np.where(bc, 0.5 - 0.5 * contr + bright, 0.0)], -1)
    hh = max(1, int(0.05 * h))
    ww = max(1, int(0.05 * w))
    y0 = rng.integers(0, h - hh + 1, batch)
    x0 = rng.integers(0, w - ww + 1, batch)
    cut = rng.random(batch) < 0.5
    pi = np.stack([np.where(cut, y0, 0), np.where(cut, y0 + hh, 0),
                   np.where(cut, x0, 0), np.where(cut, x0 + ww, 0)], -1)
    return flip, pf.astype(np.float32), pi.astype(np.int32)


@pytest.mark.parametrize("h,w,batch,tile_b", [
    (32, 32, 16, 8),
    (16, 16, 8, 8),
    (10, 10, 12, 5),
])
def test_plain_matches_jax_kernel_and_oracle(h, w, batch, tile_b):
    n = 24
    images = _images(n, h, w)
    rng = np.random.default_rng(h * 100 + batch)
    jds = jip.prepare_gather_dataset(jnp.asarray(images))
    tds = tip.prepare_gather_dataset(torch.from_numpy(images))
    for _ in range(3):
        flip, pf, pi = _numpy_params(rng, batch, h, w)
        idx = rng.integers(0, n, batch).astype(np.int32)
        idx_eff = (idx + n * flip).astype(np.int32)
        got = tip.fused_light_pipeline(
            tds, torch.from_numpy(idx_eff), torch.from_numpy(pf),
            torch.from_numpy(pi), h=h, w=w).numpy()
        kernel = np.asarray(jip.fused_light_pipeline(
            jds, jnp.asarray(idx_eff), jnp.asarray(pf), jnp.asarray(pi), h=h,
            w=w, tile_b=tile_b, interpret=True))
        oracle = np.asarray(jip.light_pipeline_reference(
            jnp.asarray(images), jnp.asarray(idx),
            jip.LightParams(jnp.asarray(flip), jnp.asarray(pf), jnp.asarray(pi))))
        assert got.shape == (batch, h, w, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, oracle)
        bc_off = pf[:, 0] == 1.0
        assert bc_off.any() and not bc_off.all()
        np.testing.assert_array_equal(got[bc_off], kernel[bc_off])
        np.testing.assert_allclose(got, kernel, rtol=0, atol=1e-6)
        # the port's own oracle, with the flip given apart from the index
        ref = tip.light_pipeline_reference(
            torch.from_numpy(images), torch.from_numpy(idx).long(),
            tip.LightParams(torch.from_numpy(flip), torch.from_numpy(pf),
                            torch.from_numpy(pi)))
        np.testing.assert_array_equal(ref.numpy(), got)


def test_identity_params_equal_plain_normalize():
    n, h, w, batch = 20, 32, 32, 16
    images = _images(n, h, w, seed=3)
    idx = np.random.default_rng(0).integers(0, n, batch).astype(np.int32)
    p = tip.identity_light_params(1, batch)
    got = tip.fused_light_pipeline(
        tip.prepare_gather_dataset(torch.from_numpy(images)),
        torch.from_numpy(idx), p.pf[0], p.pi[0], h=h, w=w).numpy()
    np.testing.assert_array_equal(
        got, taug.normalize_images(torch.from_numpy(images[idx])).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jaug.normalize_images(jnp.asarray(images[idx]))))
    # jitted, XLA divides by the constant std as a multiply by its
    # reciprocal: within one ulp of the normalized value
    want = np.asarray(jaug.preprocess_batch(
        jax.random.PRNGKey(0), jnp.asarray(images[idx]), augment=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_draw_distributions_match_light_tier():
    """Apply-rates and ranges of the draws equal the JAX package's light
    tier: flip p .5, brightness/contrast p .2 (α ∈ [0.9, 1.1]), cutout p .2
    with a max(1, ·) sized hole inside the frame."""
    h = w = 32
    params = tip.draw_light_params(torch.Generator().manual_seed(42), 64, 256, h, w)
    assert params.flip.shape == (64, 256) and params.flip.dtype == torch.bool
    assert params.pf.dtype == torch.float32 and params.pi.dtype == torch.int32
    assert 0.47 < float(params.flip.float().mean()) < 0.53

    alpha = params.pf[..., 0].numpy()
    beta = params.pf[..., 1].numpy()
    bc_rate = float((alpha != 1.0).mean())
    assert 0.17 < bc_rate < 0.23
    assert alpha.min() >= 0.9 - 1e-6 and alpha.max() <= 1.1 + 1e-6
    assert (beta[alpha == 1.0] == 0.0).all()

    pi = params.pi.numpy()
    active = pi[..., 1] > pi[..., 0]
    assert 0.17 < float(active.mean()) < 0.23
    hh = pi[..., 1] - pi[..., 0]
    assert hh[active].min() >= 1 and pi[..., 1].max() <= h
    assert (pi[..., 0] >= 0).all() and (pi[..., 2] >= 0).all()
    assert (pi[..., 1][~active] == 0).all()
    again = tip.draw_light_params(torch.Generator().manual_seed(42), 64, 256, h, w)
    assert all(torch.equal(a, b) for a, b in zip(params, again))


def test_light_tier_rates_and_normalize():
    """augment_batch('light'): about half the images flipped, the rest
    untouched where neither brightness nor a hole hit; preprocess_batch
    normalizes after; medium and heavy give [0, 1] images of the same shape
    (their parity is in test_torch_augment.py)."""
    images = torch.from_numpy(_images(400, 8, 8, seed=5))
    out = taug.augment_batch(torch.Generator().manual_seed(1), images, "light")
    same = (out == images).flatten(1).all(1).float().mean()
    flipped = (out == images.flip(2)).flatten(1).all(1).float().mean()
    assert 0.25 < float(same) < 0.45 and 0.25 < float(flipped) < 0.45
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    x = taug.preprocess_batch(torch.Generator().manual_seed(1), images, "light")
    torch.testing.assert_close(x, taug.normalize_images(out), rtol=0, atol=0)
    for strength in ("medium", "heavy"):
        got = taug.augment_batch(torch.Generator(), images, strength)
        assert got.shape == images.shape and got.dtype == torch.float32
        assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_light_tier_ops_match_jax():
    """The brightness/contrast and cutout formulas on the same draws."""
    rng = np.random.default_rng(9)
    x = rng.random((6, 8, 8, 3), np.float32)
    apply = rng.random((6, 1, 1, 1)) < 0.5
    bright = rng.uniform(-0.1, 0.1, (6, 1, 1, 1)).astype(np.float32)
    contr = (1 + rng.uniform(-0.1, 0.1, (6, 1, 1, 1))).astype(np.float32)
    want = np.asarray(jnp.where(
        apply, jnp.clip((x - 0.5) * contr + 0.5 + bright, 0.0, 1.0), x))
    got = taug.apply_brightness_contrast(
        *(torch.from_numpy(np.asarray(a)) for a in (x, apply, bright, contr)))
    np.testing.assert_array_equal(got.numpy(), want)

    cut = rng.random((6, 1, 1, 1)) < 0.5
    y0, x0 = rng.integers(0, 6, 6).astype(np.int32), rng.integers(0, 6, 6).astype(np.int32)
    hh = ww = np.full(6, 2, np.int32)
    want = np.asarray(jaug._apply_cutout(jnp.asarray(x), cut, y0, hh, x0, ww))
    got = taug.apply_cutout(*(torch.from_numpy(np.asarray(a))
                              for a in (x, cut, y0, hh, x0, ww)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_of_range_arguments_raise():
    ds = tip.prepare_gather_dataset(torch.zeros((4, 8, 8, 3)))
    p = tip.identity_light_params(1, 3)
    with pytest.raises(ValueError, match="dataset"):
        tip.fused_light_pipeline(ds, torch.zeros(3, dtype=torch.int32),
                                 p.pf[0], p.pi[0], h=16, w=16)
    with pytest.raises(ValueError, match="pf"):
        tip.fused_light_pipeline(ds, torch.zeros(3, dtype=torch.int32),
                                 p.pf[0][:2], p.pi[0], h=8, w=8)
    with pytest.raises(ValueError, match="CUDA"):
        tip._launch(ds, torch.zeros(3, dtype=torch.int32), p.pf[0], p.pi[0], 8, 8)
