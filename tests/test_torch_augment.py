"""The medium and heavy augmentation tiers of the port against the JAX
package: the same geometric draws compose into the same per-sample inverse
maps (M, v); the port's draws hit the tier tables' gate rates and
parameter ranges; the heavy tier warps a second time after the medium
photometric block; one step's draws travel as one packed buffer.

Tolerances: (M, v) atol 1e-6 (a 2×2 product summed in another order);
gate rates within 5 binomial standard deviations at batch 20,000.
"""

import math

import jax
import numpy as np
import pytest
import torch

from nnue_vision_tpu.data import augment as A
from nnue_vision_tpu_torch.data import augment as taug
from nnue_vision_tpu_torch.ops import photometric_kernel as tpk

H = W = 32


def _jax_draws(key, b, kind, p, max_deg=0.0, max_translate=0.0,
               scale_range=(1.0, 1.0), h=H, w=W):
    """The values the JAX geometric op draws from `key`, drawn the way it
    draws them (data/augment.py:130-181)."""
    if kind == "hflip":
        return (jax.random.uniform(key, (b,)) < p,)
    if kind == "rot90":
        k_apply, k_choice = jax.random.split(key)
        return (jax.random.uniform(k_apply, (b,)) < p,
                jax.random.randint(k_choice, (b,), 0, 4))
    keys = jax.random.split(key, 5)
    return (jax.random.uniform(keys[0], (b,)) < p,
            jax.random.uniform(keys[1], (b,), minval=-max_deg, maxval=max_deg),
            jax.random.uniform(keys[2], (b,), minval=-max_translate,
                               maxval=max_translate) * w,
            jax.random.uniform(keys[3], (b,), minval=-max_translate,
                               maxval=max_translate) * h,
            jax.random.uniform(keys[4], (b,), minval=scale_range[0],
                               maxval=scale_range[1]))


def _t(values):
    return [torch.from_numpy(np.array(v)) for v in values]


@pytest.mark.parametrize("tier", ["medium", "heavy"])
def test_composition_matches_jax(tier):
    """The tier's four geometric ops, with the same draws, compose to the
    same (M, v) as `_mv_compose` over the JAX ops."""
    b = 256
    if tier == "medium":
        p_flip, p_rot, p_aff, deg, tr, sc = 0.5, 0.5, 0.3, 15.0, 0.1, (0.9, 1.1)
    else:
        p_flip, p_rot, p_aff, deg, tr, sc = 0.1, 0.1, 0.2, 25.0, 0.15, (0.85, 1.15)
    ks = list(jax.random.split(jax.random.PRNGKey(7 if tier == "medium" else 8), 4))
    want = A._geom_hflip(ks[0], b, p_flip)
    want = A._mv_compose(want, A._geom_rot90(ks[1], b, p_rot))
    want = A._mv_compose(want, A._geom_affine(ks[2], b, p_aff, deg, 0.0,
                                              (1.0, 1.0001), H, W))
    want = A._mv_compose(want, A._geom_affine(ks[3], b, p_aff, deg, tr, sc, H, W))

    got = taug.geom_hflip(*_t(_jax_draws(ks[0], b, "hflip", p_flip)))
    got = taug._mv_compose(got, taug.geom_rot90(*_t(_jax_draws(ks[1], b, "rot90", p_rot))))
    got = taug._mv_compose(got, taug.geom_affine(*_t(_jax_draws(
        ks[2], b, "affine", p_aff, deg, 0.0, (1.0, 1.0001)))))
    got = taug._mv_compose(got, taug.geom_affine(*_t(_jax_draws(
        ks[3], b, "affine", p_aff, deg, tr, sc))))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=1e-6)


def _binomial_ok(hits, n, p):
    return abs(hits - n * p) <= 5 * math.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("variant", ["medium", "heavy_extra"])
def test_photometric_draw_rates_and_ranges(variant):
    """Gates at the tier table's rates, every parameter inside its range
    (data/augment.py:700-736 of the JAX package)."""
    n = 20000
    gen = torch.Generator().manual_seed(3)
    draw = (taug.draw_medium_photometric if variant == "medium"
            else taug.draw_heavy_photometric)
    f, i = draw(gen, n, H, W)
    nf, ni = tpk.VARIANTS[variant]
    assert f.shape == (n, nf) and f.dtype == torch.float32
    assert i.shape == (n, ni) and i.dtype == torch.int32
    if variant == "medium":
        rates = {0: .3, 3: .3, 7: .2, 8: .2, 10: .3, 11: .2, 15: .1, 20: .1,
                 22: .1, 23: .1}
        ranges = {1: (-.2, .2), 2: (.8, 1.2), 4: (-10 / 255, 10 / 255),
                  5: (.85, 1.15), 6: (1 - 10 / 255, 1 + 10 / 255), 9: (.01, .05),
                  12: (-8 / 255, 8 / 255), 13: (.9, 1.1), 14: (1 - 8 / 255, 1 + 8 / 255),
                  16: (-1, 1), 17: (-1, 1), 18: (-.3, .3), 19: (.4, .7), 21: (.1, .4)}
        holes, frac = [(0, 4)], (0.05, 0.15)
        np.testing.assert_allclose(f[:, 16] ** 2 + f[:, 17] ** 2, 1.0, atol=1e-6)
    else:
        rates = {0: .2, 3: .2, 7: .2, 8: .2, 10: .2, 11: .2}
        ranges = {1: (-.3, .3), 2: (.7, 1.3), 4: (-15 / 255, 15 / 255),
                  5: (.8, 1.2), 6: (1 - 15 / 255, 1 + 15 / 255), 9: (.05, .1)}
        holes, frac = [(0, 4), (4, 8)], (0.1, 0.25)
    for col, p in rates.items():
        g = f[:, col]
        assert set(g.unique().tolist()) <= {0.0, 1.0}, col
        assert _binomial_ok(int(g.sum()), n, p), (col, float(g.mean()))
    for col, (lo, hi) in ranges.items():
        assert float(f[:, col].min()) >= lo - 1e-6 and float(f[:, col].max()) <= hi + 1e-6, col
        assert float(f[:, col].max() - f[:, col].min()) > 0.9 * (hi - lo), col
    for a, z in holes:
        y0, hh, x0, ww = i[:, a:z].T
        assert int(hh.min()) >= max(1, int(frac[0] * H)) and int(hh.max()) <= int(frac[1] * H)
        assert torch.equal(hh, ww)
        assert bool((y0 >= 0).all() & (y0 + hh <= H).all() & (x0 + ww <= W).all())


@pytest.mark.parametrize("tier,p_aff,scale", [("medium", 0.3, (0.9, 1.1)),
                                              ("heavy", 0.2, (0.85, 1.15))])
def test_geometry_draw_rates_and_ranges(tier, p_aff, scale):
    """The composed maps are conformal with scale 1/sc inside the affine's
    range; a map off unit determinant (the affine op applied) at its rate;
    the translation bounded by the affine's."""
    n = 20000
    draw = taug.draw_medium_geometry if tier == "medium" else taug.draw_heavy_geometry
    m, v = draw(torch.Generator().manual_seed(4), n, H, W)
    det = torch.linalg.det(m.double())
    s = det.abs().sqrt()
    assert float(s.min()) >= 1 / scale[1] / 1.0001 - 1e-6
    assert float(s.max()) <= 1 / scale[0] + 1e-6
    np.testing.assert_allclose((m.double() @ m.double().transpose(1, 2)).numpy(),
                               (det.abs()[:, None, None] * torch.eye(2)).numpy(),
                               atol=1e-5)
    off = int(((det.abs() - 1).abs() > 1e-3).sum())
    share_sc = 1 - 1e-3 / (scale[1] - scale[0])  # P(|1/sc² - 1| > 1e-3)
    assert _binomial_ok(off, n, p_aff * share_sc), off / n
    bound = (0.1 if tier == "medium" else 0.15) * H * math.sqrt(2) / scale[0]
    assert float(v.norm(dim=1).max()) <= bound + 1e-4


@pytest.mark.parametrize("tier", ["medium", "heavy"])
def test_tier_order_and_packing(tier, monkeypatch):
    """medium: warp → medium block; heavy: then a second warp → heavy_extra,
    each on the images the step before made, with the draws of one step
    uploaded as one buffer in the JAX package's draw order."""
    calls = []
    real_warp, real_photo = taug.warp_bilinear, taug.photometric_block

    def warp(x, params):
        calls.append(("warp", params))
        return real_warp(x, params)

    def photo(x, noise, f, i, *, variant):
        calls.append((variant, f))
        return real_photo(x, noise, f, i, variant=variant)

    monkeypatch.setattr(taug, "warp_bilinear", warp)
    monkeypatch.setattr(taug, "photometric_block", photo)
    b = 64
    images = torch.rand((b, H, W, 3), generator=torch.Generator().manual_seed(5))
    out = taug.augment_batch(torch.Generator().manual_seed(6), images, tier)
    assert out.shape == images.shape and out.dtype == torch.float32
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    kinds = [c[0] for c in calls]
    assert kinds == (["warp", "medium"] if tier == "medium"
                     else ["warp", "medium", "warp", "heavy_extra"])

    gen = torch.Generator().manual_seed(6)
    draws = taug.draw_tier(gen, tier, b, H, W, "cpu")
    gen = torch.Generator().manual_seed(6)
    want = [taug._warp_params(taug.draw_medium_geometry(gen, b, H, W), H, W),
            *taug.draw_medium_photometric(gen, b, H, W)]
    if tier == "heavy":
        want += [taug._warp_params(taug.draw_heavy_geometry(gen, b, H, W), H, W),
                 *taug.draw_heavy_photometric(gen, b, H, W)]
    got = [draws.warp1, *draws.photo1]
    if tier == "heavy":
        got += [draws.warp2, *draws.photo2]
    else:
        assert draws.warp2 is None and draws.photo2 is None
    for g, w_ in zip(got, want, strict=True):
        assert g.dtype == w_.dtype and torch.equal(g, w_)
    assert torch.equal(calls[0][1], draws.warp1)


def test_same_seed_same_images():
    images = torch.rand((16, H, W, 3), generator=torch.Generator().manual_seed(9))
    runs = [taug.preprocess_batch(torch.Generator().manual_seed(1), images, "heavy",
                                  noise_gen=torch.Generator().manual_seed(2))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    other = taug.preprocess_batch(torch.Generator().manual_seed(1), images, "heavy",
                                  noise_gen=torch.Generator().manual_seed(3))
    assert not torch.equal(runs[0], other)
