"""The port's float NNUE, quantizer and weight bridge held against the JAX
package on the same numpy params, and the whole serving slice (float
params → quantize → `.nnue` → mega serve) held bit-equal to the JAX chain."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu import formats
from nnue_vision_tpu.models import nnue as jnnue
from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu.ops import pallas_kernels as jpk
from nnue_vision_tpu_torch import bridge
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models import nnue as tnnue
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.ops import nnue_kernels as nk

WIDTHS = dict(l1_size=16, l2_size=8, l3_size=4, num_classes=3, input_size=12)


def _cfgs(**kw):
    j = jnnue.NNUEConfig(feature_set=jnnue.GridFeatureSet(4, 6), **WIDTHS, **kw)
    t = tnnue.NNUEConfig(feature_set=tnnue.GridFeatureSet(4, 6), **WIDTHS, **kw)
    return j, t


def _params(rng, thresholds=(0.1, 0.12, 0.08, 0.1, 0.11, 0.09)):
    """Float params with the JAX package's init distributions (numpy)."""
    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {
        "conv_w": u((6, 3, 3, 3), 27),
        "visual_threshold": np.asarray(thresholds, np.float32),
        "ft_w": (rng.standard_normal((96, 16)) * 0.1).astype(np.float32),
        "ft_b": (rng.standard_normal(16) * 0.05).astype(np.float32),
        "fc1_w": u((8, 16), 16), "fc1_b": u((8,), 16),
        "fc2_w": u((4, 8), 8), "fc2_b": u((4,), 8),
        "out_w": u((3, 4), 4), "out_b": u((3,), 4),
        "nnue2score": np.float32(600.0),
    }


def _images(rng, b=6, h=12):
    return rng.random((b, h, h, 3), dtype=np.float32)


def _conv_margins(p, imgs, cfg):
    """Per image, the smallest |conv output - threshold| the model's compare
    sees, in float64, with the conv weights and threshold its forward uses."""
    w = p["conv_w"].astype(np.float64)
    t = p["visual_threshold"].astype(np.float64)
    if cfg.qat:
        t = np.full_like(t, t.mean())
        if cfg.qat_rounding:
            w = np.round(np.clip(w, -127 / 64, 127 / 64) * 64) / 64
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(imgs).permute(0, 3, 1, 2).double(),
        torch.from_numpy(w), stride=cfg.conv_stride, padding=1)
    return np.abs(conv.permute(0, 2, 3, 1).numpy() - t).min(axis=(1, 2, 3))


def _clear_images(rng, p, cfg, b=4):
    """`b` images with no conv output within 1e-3 of the threshold, so that
    summation order cannot flip a mask bit."""
    imgs = _images(rng, b=8 * b)
    keep = imgs[_conv_margins(p, imgs, cfg) > 1e-3][:b]
    assert len(keep) == b
    return keep


@pytest.mark.parametrize("kw,thresholds", [
    pytest.param(dict(qat=False), None, id="float"),
    pytest.param(dict(qat=True), None, id="qat"),
    pytest.param(dict(qat=True, qat_rounding=False), None, id="qat-warmup"),
    pytest.param(dict(qat=True), (-0.05, -0.02, -0.04, -0.03, -0.05, -0.01),
                 id="qat-negative-threshold"),
])
def test_forward_matches_nnue_apply(kw, thresholds):
    rng = np.random.default_rng(31)
    p = _params(rng) if thresholds is None else _params(rng, thresholds)
    jcfg, tcfg = _cfgs(**kw)
    imgs = _clear_images(rng, p, tcfg)
    assert (_conv_margins(p, imgs, tcfg) > 1e-3).all()
    jl, jaux = jnnue.nnue_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(imgs), jcfg, return_aux=True)
    model = bridge.nnue_from_jax_params(p, tcfg)
    with torch.no_grad():
        tl, taux = model(torch.from_numpy(imgs), return_aux=True)
        assert torch.equal(model(torch.from_numpy(imgs)), tl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_array_equal(taux["mask"].numpy(), np.asarray(jaux["mask"]))
    np.testing.assert_array_equal(taux["density"].numpy(),
                                  np.asarray(jaux["density"]))
    if thresholds is not None:  # the padding tail is active under QAT
        assert taux["mask"][:, -42:].all()


def test_quantize_writes_the_same_nnue_bytes(tmp_path):
    rng = np.random.default_rng(32)
    p = _params(rng)
    p["ft_w"][0, :4] = [1.7, -2.0, 0.5078125, -0.5078125]  # clip + ties
    jcfg, tcfg = _cfgs(qat=True)
    formats.write_nnue(jnnue.nnue_quantize(p, jcfg), tmp_path / "jax.nnue")
    formats.write_nnue(tnnue.nnue_quantize(bridge.nnue_from_jax_params(p, tcfg)),
                       tmp_path / "torch.nnue")
    assert (tmp_path / "torch.nnue").read_bytes() == \
        (tmp_path / "jax.nnue").read_bytes()


def test_from_quantized_matches_jax():
    rng = np.random.default_rng(33)
    jcfg, tcfg = _cfgs()
    q = jnnue.nnue_quantize(_params(rng), jcfg)
    jp, jc = jnnue.nnue_from_quantized(q)
    model = tnnue.nnue_from_quantized(q)
    assert model.cfg.feature_set.num_features == jc.feature_set.num_features
    assert (model.cfg.l1_size, model.cfg.l2_size, model.cfg.l3_size,
            model.cfg.num_classes) == (jc.l1_size, jc.l2_size, jc.l3_size,
                                       jc.num_classes)
    got = bridge.nnue_to_numpy(model)
    for name, ref in jp.items():
        np.testing.assert_array_equal(got[name], np.asarray(ref), err_msg=name)


def test_clip_weights_and_count_parameters_match_jax():
    rng = np.random.default_rng(34)
    p = _params(rng)
    p["ft_w"] *= 20.0
    p["fc1_w"] *= 20.0
    jcfg, tcfg = _cfgs()
    model = bridge.nnue_from_jax_params(p, tcfg)
    assert tnnue.count_parameters(model) == jnnue.count_parameters(p)
    clipped = jnnue.nnue_clip_weights({k: jnp.asarray(v) for k, v in p.items()})
    got = bridge.nnue_to_numpy(tnnue.nnue_clip_weights(model))
    for name, ref in clipped.items():
        np.testing.assert_array_equal(got[name], np.asarray(ref), err_msg=name)


def test_bridge_round_trip_and_shape_checks():
    rng = np.random.default_rng(35)
    p = _params(rng)
    _, tcfg = _cfgs()
    got = bridge.nnue_to_numpy(bridge.nnue_from_jax_params(p, tcfg))
    assert set(got) == set(p)
    for name in p:
        np.testing.assert_array_equal(got[name], p[name])
    bad = dict(p, ft_w=p["ft_w"].T)
    with pytest.raises(ValueError, match="ft_w"):
        bridge.nnue_from_jax_params(bad, tcfg)
    with pytest.raises(KeyError, match="nnue2score"):
        bridge.nnue_from_jax_params(
            {k: v for k, v in p.items() if k != "nnue2score"}, tcfg)


def test_whole_slice_matches_jax_chain(tmp_path):
    """numpy float params → port quantize → .nnue → read → mega serve, equal
    bit for bit to the same chain through the JAX package."""
    rng = np.random.default_rng(36)
    p = _params(rng)
    jcfg, tcfg = _cfgs(qat=True)
    imgs = normalize_images(torch.from_numpy(_images(rng, b=9))).numpy()
    flat = imgs.reshape(9, -1)

    formats.write_nnue(jnnue.nnue_quantize(p, jcfg), tmp_path / "j.nnue")
    jq = formats.read_nnue(tmp_path / "j.nnue")
    jp, jc = jsim.nnue_sim_params(jq)
    ref = jpk.nnue_engine_forward_mega(
        jpk.mega_head_params(jp, jc, 12, 12), jnp.asarray(flat), cfg=jc,
        image_h=12, image_w=12, tile_b=8, interpret=True)

    model = bridge.nnue_from_jax_params(p, tcfg)
    formats.write_nnue(tnnue.nnue_quantize(model), tmp_path / "t.nnue")
    tq = formats.read_nnue(tmp_path / "t.nnue")
    tp, tc = tsim.nnue_sim_params(tq)
    got = nk.nnue_engine_forward_mega(
        nk.mega_head_params(tp, tc, 12, 12), torch.from_numpy(flat), cfg=tc,
        image_h=12, image_w=12)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0 < int(got[2].min()) and int(got[2].max()) < jq.num_features
