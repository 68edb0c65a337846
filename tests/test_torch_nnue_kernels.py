"""The plain versions of the port's two Hopper kernels, held bit-equal to
the JAX package's Pallas kernels run as its own tests run them
(`interpret=True, tile_b=8`). The kernels themselves run only on a card:
`tests/test_torch_nnue_kernels_gpu.py` holds them to these plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu.ops import pallas_kernels as jpk
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from tests.conftest import random_quantized_nnue

CASES = [  # (H, threshold): n_pad 42, the same negative, n_pad 0
    pytest.param(12, 0.07, id="n_pad42"),
    pytest.param(12, -0.25, id="n_pad42-negative-threshold"),
    pytest.param(13, 0.07, id="n_pad0"),
]
B = 5  # ragged against the JAX tile of 8


def _setup(seed, h, thresh):
    rng = np.random.default_rng(seed)
    q = random_quantized_nnue(rng, grid=4, ch=6, l1=16,
                              visual_threshold=thresh)
    imgs = (rng.random((B, h, h, 3), dtype=np.float32) * 2 - 0.5).astype(
        np.float32)
    jp, jcfg = jsim.nnue_sim_params(q)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    return q, imgs, (jp, jcfg), (tp, tcfg)


def _eq(got, ref):
    """Torch outputs (None-aware) bit-equal to JAX outputs."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
        else:
            r = np.asarray(r)
            assert g.numpy().dtype == r.dtype
            np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("h,thresh", CASES)
def test_mega_plain_matches_pallas(h, thresh):
    q, imgs, (jp, jcfg), (tp, tcfg) = _setup(21, h, thresh)
    flat = imgs.reshape(B, -1)
    jhead = jpk.mega_head_params(jp, jcfg, h, h)
    thead = nk.mega_head_params(tp, tcfg, h, h)
    jkw = dict(cfg=jcfg, image_h=h, image_w=h, tile_b=8, interpret=True)
    tkw = dict(cfg=tcfg, image_h=h, image_w=h)
    ref = jpk.nnue_engine_forward_mega(jhead, jnp.asarray(flat), **jkw)
    got = nk.nnue_engine_forward_mega(thead, torch.from_numpy(flat), **tkw)
    # density is one f32 division on both sides, correctly rounded here
    _eq((got[0], got[2]), (ref[0], ref[2]))
    np.testing.assert_array_max_ulp(got[1].numpy(), np.asarray(ref[1]), 1)
    _eq(nk.nnue_engine_forward_mega_reference(thead, torch.from_numpy(flat),
                                              **tkw), got)

    # logits-only serving on a ragged 3-image batch
    ref = jpk.nnue_engine_forward_mega(jhead, jnp.asarray(flat[:3]),
                                       with_count=False, **jkw)
    got = nk.nnue_engine_forward_mega(thead, torch.from_numpy(flat[:3]),
                                      with_count=False, **tkw)
    _eq(got, ref)

    # qbf16: host pre-quantized bfloat16 input, the same bits out
    jq = jpk.quantize_images_for_mega(flat, jcfg)
    tq = nk.quantize_images_for_mega(torch.from_numpy(flat), tcfg)
    assert tq.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.float().numpy(), jq.astype(np.float32))
    ref = jpk.nnue_engine_forward_mega(jhead, jnp.asarray(jq),
                                       input_mode="qbf16", **jkw)
    got = nk.nnue_engine_forward_mega(thead, tq, input_mode="qbf16", **tkw)
    _eq((got[0], got[2]), (ref[0], ref[2]))


@pytest.mark.parametrize("h,thresh", CASES)
def test_fused_plain_matches_pallas(h, thresh):
    q, imgs, (jp, jcfg), (tp, tcfg) = _setup(22, h, thresh)
    jhead = jpk.pallas_head_params(jp)
    thead = nk.pallas_head_params(tp)
    jkw = dict(cfg=jcfg, image_h=h, image_w=h, tile_b=8, interpret=True)
    tkw = dict(cfg=tcfg, image_h=h, image_w=h)
    x = torch.from_numpy(imgs)
    ref = jpk.nnue_engine_forward_fused(jp, jhead, imgs, **jkw)
    got = nk.nnue_engine_forward_fused(tp, thead, x, **tkw)
    _eq((got[0], got[2]), (ref[0], ref[2]))
    _eq(nk.nnue_engine_forward_fused_reference(tp, thead, x, **tkw), got)
    ref = jpk.nnue_engine_forward_fused(jp, jhead, imgs, with_count=False,
                                        **jkw)
    _eq(nk.nnue_engine_forward_fused(tp, thead, x, with_count=False, **tkw),
        ref)


def test_fused_head_plain_matches_pallas():
    """The padded-buffer entry point (conv_scale 1, n_pad 0), ragged batch."""
    rng = np.random.default_rng(23)
    q = random_quantized_nnue(rng, grid=4, ch=6, l1=16)
    buf = rng.integers(-127, 128, (3, q.num_features)).astype(np.float32)
    jp, jcfg = jsim.nnue_sim_params(q)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    thead = nk.pallas_head_params(tp)
    ref = jpk.fused_nnue_head(jpk.pallas_head_params(jp), jnp.asarray(buf),
                              cfg=jcfg, tile_b=8, interpret=True)
    got = nk.fused_nnue_head(thead, torch.from_numpy(buf), cfg=tcfg)
    _eq(got, ref)
    assert got[0].shape == (3, 3) and got[1].shape == (3,)
    _eq(nk.fused_nnue_head_reference(thead, torch.from_numpy(buf), cfg=tcfg),
        got)
    np.testing.assert_array_equal(
        got[1].numpy(), (buf > q.visual_threshold).sum(axis=1))


def test_large_ft_weights_stay_exact():
    """int16 FT weights beyond the bf16 window (the JAX f32 fallback case)."""
    rng = np.random.default_rng(24)
    q = random_quantized_nnue(rng, grid=4, ch=4, l1=16)
    q.ft.weight[:] = rng.integers(-30000, 30000, q.ft.weight.shape)
    imgs = (rng.random((3, 12, 12, 3), dtype=np.float32) * 2 - 0.5).astype(
        np.float32)
    jp, jcfg = jsim.nnue_sim_params(q)
    ref = jsim.nnue_engine_forward(jp, imgs, cfg=jcfg, image_h=12, image_w=12)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    got = nk.nnue_engine_forward_fused(
        tp, nk.pallas_head_params(tp), torch.from_numpy(imgs), cfg=tcfg,
        image_h=12, image_w=12)
    _eq((got[0], got[2]), (ref[0], ref[2]))
    got = nk.nnue_engine_forward_mega(
        nk.mega_head_params(tp, tcfg, 12, 12),
        torch.from_numpy(imgs.reshape(3, -1)), cfg=tcfg, image_h=12,
        image_w=12)
    _eq((got[0], got[2]), (ref[0], ref[2]))


def test_padsum_is_the_padding_rows():
    q = random_quantized_nnue(np.random.default_rng(25), grid=4, ch=6, l1=16)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    head = nk.mega_head_params(tp, tcfg, 12, 12)  # FR 54, n_pad 42
    np.testing.assert_array_equal(
        head["padsum"].numpy(), q.ft.weight[54:].astype(np.int64).sum(axis=0))
    assert head["padsum"].dtype == torch.int32


def test_mega_rejects_images_beyond_shared_memory():
    q = random_quantized_nnue(np.random.default_rng(26), grid=4, ch=6, l1=16)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    # two staged images of 64·74·3·4 B, their quantized copies and a tile
    # of 16 rows: 231,808 B of the 232,448 a block may use; at 76 columns
    # 237,952 B
    nk.mega_head_params(tp, tcfg, 64, 74)
    with pytest.raises(ValueError, match="nnue_engine_forward_fused"):
        nk.mega_head_params(tp, tcfg, 64, 76)


def test_qbf16_window_and_input_mode_checks():
    q = random_quantized_nnue(np.random.default_rng(27), grid=4, ch=6, l1=16)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    with pytest.raises(ValueError, match="exact-integer window"):
        nk.quantize_images_for_mega(torch.full((1, 432), 4.02), tcfg)
    head = nk.mega_head_params(tp, tcfg, 12, 12)
    with pytest.raises(ValueError, match="input_mode"):
        nk.nnue_engine_forward_mega(head, torch.zeros(1, 432), cfg=tcfg,
                                    image_h=12, image_w=12, input_mode="f16")


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    q = random_quantized_nnue(np.random.default_rng(28), grid=4, ch=6, l1=16)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    nk.reset_launch_counts()
    nk.nnue_engine_forward_mega(nk.mega_head_params(tp, tcfg, 12, 12),
                                torch.zeros(2, 432), cfg=tcfg, image_h=12,
                                image_w=12)
    nk.nnue_engine_forward_fused(tp, nk.pallas_head_params(tp),
                                 torch.zeros(2, 12, 12, 3), cfg=tcfg,
                                 image_h=12, image_w=12)
    assert nk.LAUNCHES == {"nnue_mega_kernel": 0, "nnue_head_kernel": 0,
                           "nnue_mega_stage_kernel": 0}


def test_kernel_wrappers_raise_off_cuda():
    """A tensor that is neither on the CPU nor on a card reaches the kernel
    wrapper and raises: nothing falls back to the plain version."""
    q = random_quantized_nnue(np.random.default_rng(29), grid=4, ch=6, l1=16)
    tp, tcfg = tsim.nnue_sim_params(q, device="cpu")
    head = nk.mega_head_params(tp, tcfg, 12, 12)
    meta = torch.zeros(2, 432, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nk.nnue_engine_forward_mega(head, meta, cfg=tcfg, image_h=12,
                                    image_w=12)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nk.fused_nnue_head(head, torch.zeros(2, 96, device="meta"), cfg=tcfg)
