"""The port's int8 engine sim held bit-equal to the JAX sim and the numpy
oracle (`nnue_vision_tpu/ops/engine_sim_np.py`, itself held to the C++
engine binaries). Inputs come from numpy seeds; every place where
bit-exactness is likely to break has a test named after it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu.ops.engine_sim_np import nnue_forward_np
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from tests.conftest import random_quantized_nnue

# grid 4, 6 channels, L1 16: H 12 leaves n_pad = 42 padding features, H 13
# fills the grid exactly (n_pad = 0); a negative threshold activates them.
CASES = [
    pytest.param(12, 0.07, 42, id="n_pad42"),
    pytest.param(12, -0.25, 42, id="n_pad42-negative-threshold"),
    pytest.param(13, 0.07, 0, id="n_pad0"),
]


def _images(rng, b, h, w=None):
    w = h if w is None else w
    return (rng.random((b, h, w, 3), dtype=np.float32) * 2 - 0.5).astype(
        np.float32
    )


def _both(q, imgs):
    h, w = imgs.shape[1:3]
    jp, jcfg = jsim.nnue_sim_params(q)
    jl, jd, jc = jsim.nnue_engine_forward(jp, imgs, cfg=jcfg, image_h=h,
                                          image_w=w)
    tp, tcfg = tsim.nnue_sim_params(q)
    tl, td, tc = tsim.nnue_engine_forward(tp, torch.from_numpy(imgs),
                                          cfg=tcfg, image_h=h, image_w=w)
    return (np.asarray(jl), np.asarray(jd), np.asarray(jc)), (
        tl.numpy(), td.numpy(), tc.numpy())


@pytest.mark.parametrize("h,thresh,n_pad", CASES)
def test_sim_matches_jax_sim(h, thresh, n_pad):
    rng = np.random.default_rng(11)
    q = random_quantized_nnue(rng, grid=4, ch=6, l1=16,
                              visual_threshold=thresh)
    stride = tsim.engine_conv_stride(h, 4)
    oh, ow = tsim.conv_out_hw(h, h, stride)
    assert q.num_features - oh * ow * 6 == n_pad
    (jl, jd, jc), (tl, td, tc) = _both(q, _images(rng, 7, h))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == np.int32 and tl.dtype == np.float32
    # density: XLA's f32 divide may be 1 ulp off a correctly rounded one
    np.testing.assert_array_max_ulp(td, jd, maxulp=1)
    if thresh < 0:
        assert tc.min() >= n_pad  # the padding features are active


@pytest.mark.parametrize("h,thresh,n_pad", CASES)
def test_sim_matches_numpy_oracle(h, thresh, n_pad):
    """Per image against the host oracle: logits bit-equal and density
    exact (one correctly rounded f32 division, as the engine does)."""
    rng = np.random.default_rng(12)
    q = random_quantized_nnue(rng, grid=4, ch=6, l1=16,
                              visual_threshold=thresh)
    imgs = _images(rng, 5, h)
    p, cfg = tsim.nnue_sim_params(q)
    logits, density, _ = tsim.nnue_engine_forward(
        p, torch.from_numpy(imgs), cfg=cfg, image_h=h, image_w=h)
    for i in range(len(imgs)):
        ref_logits, ref_density = nnue_forward_np(q, imgs[i])
        np.testing.assert_array_equal(logits[i].numpy(), ref_logits)
        assert float(density[i]) == ref_density


def test_truncating_division_rounds_toward_zero():
    """torch's `//` floors for negatives; the engine's C `/` truncates."""
    a = np.arange(-700, 701, 7, dtype=np.int32)
    got = tsim._tdiv(torch.from_numpy(a), 64).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsim._tdiv(jnp.asarray(a), 64)))
    np.testing.assert_array_equal(got, np.trunc(a / 64).astype(np.int32))
    assert (torch.from_numpy(a) // 64).numpy()[0] != got[0]  # floor differs


def test_int16_wraparound_matches_jax():
    a = np.array([-70000, -32769, -32768, -1, 0, 32767, 32768, 65535, 70000],
                 np.int32)
    got = tsim._wrap_i16(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsim._wrap_i16(jnp.asarray(a))))
    np.testing.assert_array_equal(got, a.astype(np.int16))


def test_engine_stride_rule_matches_jax():
    for h in (1, 2, 7, 12, 13, 16, 32, 64):
        for grid in (1, 2, 4, 5, 10):
            assert tsim.engine_conv_stride(h, grid) == \
                jsim.engine_conv_stride(h, grid)
    with pytest.raises(ValueError):
        tsim.engine_conv_stride(32, 0)


@pytest.mark.parametrize("h,w,grid,ch", [
    (12, 12, 4, 4),   # stride 4
    (16, 16, 4, 6),   # stride 5
    (32, 32, 10, 8),  # flagship geometry, stride 4
    (20, 12, 4, 4),   # non-square image
])
def test_int_conv_layout_matches_jax(h, w, grid, ch):
    """Layouts: NHWC in and out, OIHW weights; the flat feature order is
    f = (i·ow + j)·C + c, i.e. NHWC flattening (an NCHW conv must be
    permuted before the reshape)."""
    rng = np.random.default_rng(13)
    conv_w = rng.integers(-127, 128, (ch, 3, 3, 3)).astype(np.int32)
    conv_b = rng.integers(-500, 500, (ch,)).astype(np.int32)
    stride = tsim.engine_conv_stride(h, grid)
    imgs = _images(rng, 3, h, w)
    jq = jsim._quantize_input(jnp.asarray(imgs), 64.0)
    ref = np.asarray(jsim._int_conv3x3(jq, jnp.asarray(conv_w),
                                       jnp.asarray(conv_b), stride))
    tq = tsim._quantize_input(torch.from_numpy(imgs), 64.0)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    got = tsim._int_conv3x3(tq, torch.from_numpy(conv_w),
                            torch.from_numpy(conv_b), stride)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the same conv through F.conv2d (NCHW, float64: exact) after a permute
    nchw = torch.nn.functional.conv2d(
        tq.permute(0, 3, 1, 2).double(), torch.from_numpy(conv_w).double(),
        torch.from_numpy(conv_b).double(), stride=stride, padding=1)
    np.testing.assert_array_equal(
        nchw.permute(0, 2, 3, 1).reshape(3, -1).numpy(),
        got.reshape(3, -1).numpy().astype(np.float64))


def test_int_conv_exact_where_float32_is_not():
    """TF32 and Winograd: a float32 conv (cuDNN runs it in TF32 by default
    and may pick Winograd) rounds once sums pass 2^24. The plain conv
    multiplies in float64, exact for any int32 input, so it matches an
    int64 loop where float32 does not."""
    rng = np.random.default_rng(18)
    q = rng.integers(-2 ** 20, 2 ** 20, (2, 9, 9, 3)).astype(np.int32)
    w = rng.integers(-127, 128, (4, 3, 3, 3)).astype(np.int32)
    bias = rng.integers(-500, 500, (4,)).astype(np.int32)
    got = tsim._int_conv3x3(torch.from_numpy(q), torch.from_numpy(w),
                            torch.from_numpy(bias), 2).numpy()
    qpad = np.pad(q.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ref = np.zeros(got.shape, np.int64) + bias
    for kh in range(3):
        for kw in range(3):
            patch = qpad[:, kh:kh + 9:2, kw:kw + 9:2]  # (2, 5, 5, 3)
            ref += patch @ w[:, :, kh, kw].T.astype(np.int64)
    np.testing.assert_array_equal(got, ref)
    f32 = torch.nn.functional.conv2d(
        torch.from_numpy(q).permute(0, 3, 1, 2).float(),
        torch.from_numpy(w).float(), torch.from_numpy(bias).float(),
        stride=2, padding=1).permute(0, 2, 3, 1).double().numpy()
    assert (f32 != ref).any()  # the hazard is real at these magnitudes


def test_threshold_compared_as_float32():
    """126.99999999 rounds to 127.0f: a (saturated) conv output of 127 is
    INACTIVE in the engine (127.0f > 127.0f is false), though
    127 > 126.99999999 in float64."""
    rng = np.random.default_rng(14)
    q = random_quantized_nnue(rng, grid=4, ch=6, l1=16,
                              visual_threshold=126.99999999)
    imgs = _images(rng, 8, 12)
    p, cfg = tsim.nnue_sim_params(q)
    buf = tsim.nnue_conv_buffer(p, torch.from_numpy(imgs), cfg=cfg, image_h=12)
    assert bool((buf == 127).any()), "no conv output hits the edge case"
    (jl, _, jc), (tl, _, tc) = _both(q, imgs)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, (buf.numpy() > 127).sum(axis=1))
    assert (tc < (buf.numpy() > 126.99999999).sum(axis=1)).all()


def test_conv_buffer_matches_jax_feature_mask():
    rng = np.random.default_rng(15)
    q = random_quantized_nnue(rng, grid=4, ch=6, l1=16)
    imgs = _images(rng, 4, 12)
    jp, jcfg = jsim.nnue_sim_params(q)
    mask = np.asarray(jsim.nnue_feature_mask(jp, imgs, cfg=jcfg, image_h=12,
                                             image_w=12))
    p, cfg = tsim.nnue_sim_params(q)
    buf = tsim.nnue_conv_buffer(p, torch.from_numpy(imgs), cfg=cfg, image_h=12)
    assert buf.shape == (4, q.num_features)
    np.testing.assert_array_equal(
        (buf.float() > p["visual_threshold"]).numpy(), mask > 0)


def test_ft_sums_beyond_2_24_stay_exact():
    """JAX's exactness limit: its sim sums the FT in f32, exact only below
    2^24. The port sums exactly for any int16 weights, so it is held to the
    numpy oracle where all 800 flagship-grid features are active and the
    FT sums reach ~2^24.3."""
    rng = np.random.default_rng(16)
    q = random_quantized_nnue(rng, grid=10, ch=8, l1=16,
                              visual_threshold=-200.0)
    q.ft.weight[:] = rng.integers(20000, 32767, q.ft.weight.shape)
    imgs = _images(rng, 2, 32)
    p, cfg = tsim.nnue_sim_params(q)
    logits, _, count = tsim.nnue_engine_forward(
        p, torch.from_numpy(imgs), cfg=cfg, image_h=32, image_w=32)
    assert int(count.min()) == q.num_features
    assert int(q.ft.weight.astype(np.int64).sum(axis=0).max()) > 2 ** 24
    for i in range(2):
        np.testing.assert_array_equal(logits[i].numpy(),
                                      nnue_forward_np(q, imgs[i])[0])


def test_sim_params_keep_nnue_dtypes():
    q = random_quantized_nnue(np.random.default_rng(17))
    p, cfg = tsim.nnue_sim_params(q)
    assert p["ft_w"].dtype == torch.int16
    assert p["fc1_w"].dtype == torch.int8
    assert p["visual_threshold"].dtype == torch.float32
    _, jcfg = jsim.nnue_sim_params(q)
    for field in ("grid_size", "channels", "l1", "l2", "l3", "num_classes",
                  "conv_scale", "fc1_scale", "fc2_scale", "out_scale",
                  "quantized_one"):
        assert getattr(cfg, field) == getattr(jcfg, field)


def test_conv_inputs_bf16_safe_matches_jax():
    for m in (1.0, 3.99, 4.0, 4.01):
        x = np.full((1, 2, 2, 3), m, np.float32)
        assert tsim.conv_inputs_bf16_safe(torch.from_numpy(x), 64) == \
            jsim.conv_inputs_bf16_safe(x, 64)
