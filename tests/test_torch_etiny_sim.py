"""The port's EtinyNet int8 engine sim and the plain version of its LB-block
kernel (K6) held bit-equal to the JAX package: `etiny_engine_forward`
against the JAX sim and `engine_sim_np.etiny_forward_np` (the numpy oracle
of the C++ `etinynet_inference` binary), including the engine's stride-2
dense quirk; `etiny_forward_kernel` and `lb_block` on CPU tensors against
`etiny_forward_pallas` and `lb_block_pallas` in interpret mode. Every
comparison is exact: the logits are integers divided by a power of two.
No C++ engine is built.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnue_vision_tpu.formats import QConv, QLBBlock, QLinear, QuantizedEtinyNet
from nnue_vision_tpu.ops import engine_sim as jsim
from nnue_vision_tpu.ops import etiny_pallas as jpallas
from nnue_vision_tpu.ops.engine_sim_np import etiny_forward_np
from nnue_vision_tpu_torch.ops import engine_sim as tsim
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from tests.conftest import random_quantized_etiny


def _random_etiny(rng, *, dense_stride2=False, big_bias=False):
    """Micro-scale random int model: stride-2 LB, stride-1 LB (or a
    stride-2 dense block), stride-1 dense. `big_bias` gives the pw-expand
    biases the full int32 range the engine's sums can reach."""
    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    def bias(n):
        hi = 300000 if big_bias else 2000
        return rng.integers(-hi, hi, n).astype(np.int32)

    blocks = [
        QLBBlock(pw_expand=i8(16, 8), dw=i8(16, 3, 3), pw_project=i8(16, 16),
                 stride=2, pw_expand_bias=bias(16)),
        QLBBlock(pw_expand=i8(24, 16), dw=i8(24, 3, 3), pw_project=i8(24, 24),
                 stride=2 if dense_stride2 else 1, is_dense=dense_stride2,
                 pw_expand_bias=bias(24)),
        QLBBlock(pw_expand=i8(24, 24), dw=i8(24, 3, 3), pw_project=i8(24, 24),
                 stride=1, is_dense=True, pw_project_scale=4.0,
                 pw_expand_bias=bias(24)),
    ]
    return QuantizedEtinyNet(
        variant="micro", num_classes=10, input_size=32, conv_channels=8,
        final_channels=24,
        stem=QConv(weight=i8(8, 3, 3, 3),
                   bias=rng.integers(-500, 500, 8).astype(np.int32)),
        blocks=blocks,
        classifier=QLinear(weight=i8(10, 24),
                           bias=rng.integers(-2000, 2000, 10).astype(np.int32)),
    ).validate()


def _images(rng, b, h=32):
    return rng.standard_normal((b, h, h, 3)).astype(np.float32)


def _port_logits(q, imgs, fn=tsim.etiny_engine_forward, kernel=False):
    params, cfg = tsim.etiny_sim_params(q, device="cpu")
    if kernel:
        params = ek.etiny_kernel_params(params, cfg)
    h, w = imgs.shape[1:3]
    return fn(params, torch.from_numpy(imgs), cfg=cfg, image_h=h,
              image_w=w).numpy()


@pytest.mark.parametrize("make", ["conftest", "dense_stride2", "big_bias"])
def test_sim_matches_jax_and_numpy(make):
    rng = np.random.default_rng(21)
    q = (random_quantized_etiny(rng) if make == "conftest" else
         _random_etiny(rng, dense_stride2=make == "dense_stride2",
                       big_bias=make == "big_bias"))
    imgs = _images(rng, 5)
    got = _port_logits(q, imgs)
    assert got.dtype == np.float32 and got.shape == (5, 10)
    jp, jcfg = jsim.etiny_sim_params(q)
    want = np.asarray(jsim.etiny_engine_forward(jp, jnp.asarray(imgs), cfg=jcfg,
                                                image_h=32, image_w=32))
    np.testing.assert_array_equal(got, want)
    for i in range(len(imgs)):
        np.testing.assert_array_equal(got[i], etiny_forward_np(q, imgs[i]))


def test_sim_on_a_quantized_model():
    """A model from the port's quantizer (synthetic final block, amplifier
    projection at scale 4) on normalized images."""
    from nnue_vision_tpu_torch.data.augment import normalize_images
    from nnue_vision_tpu_torch.models.etinynet import (
        EtinyNetConfig, etinynet_init, etinynet_quantize)

    model = etinynet_init(EtinyNetConfig(variant="micro", num_classes=10,
                                         input_size=32),
                          torch.Generator().manual_seed(2),
                          device="cpu").train()
    rng = np.random.default_rng(3)
    imgs = normalize_images(torch.from_numpy(
        rng.random((16, 32, 32, 3), np.float32)))
    with torch.no_grad():
        model(imgs)  # running statistics away from 0/1
    q = etinynet_quantize(model)
    x = imgs.numpy()[:6]
    got = _port_logits(q, x)
    for i in range(len(x)):
        np.testing.assert_array_equal(got[i], etiny_forward_np(q, x[i]))
    np.testing.assert_array_equal(
        _port_logits(q, x, ek.etiny_forward_kernel, kernel=True), got)


@pytest.mark.parametrize("batch", [1, 4, 9])
def test_kernel_plain_matches_pallas(batch):
    rng = np.random.default_rng(batch)
    q = _random_etiny(rng)
    imgs = _images(rng, batch)
    jp, jcfg = jsim.etiny_sim_params(q)
    want = np.asarray(jpallas.etiny_forward_pallas(
        jpallas.etiny_pallas_params(jp, jcfg), jnp.asarray(imgs), cfg=jcfg,
        image_h=32, image_w=32, interpret=True))
    got = _port_logits(q, imgs, ek.etiny_forward_kernel, kernel=True)
    np.testing.assert_array_equal(got, want)


def test_lb_block_plain_matches_lb_block_pallas():
    """Each block alone, on the activations the model feeds it: the port's
    `lb_block` (int8 in, int8 out, at the block's stride) against JAX's
    stride-1 `lb_block_pallas` subsampled as its caller does."""
    rng = np.random.default_rng(8)
    q = _random_etiny(rng)
    params, cfg = tsim.etiny_sim_params(q, device="cpu")
    kp = ek.etiny_kernel_params(params, cfg)
    jp, jcfg = jsim.etiny_sim_params(q)
    pp = jpallas.etiny_pallas_params(jp, jcfg)
    x = tsim.etiny_stem(params, torch.from_numpy(_images(rng, 3)), cfg).to(torch.int8)
    for blk, jblk, bs in zip(kp["blocks"], pp["blocks"], cfg.blocks):
        b, h, w, cin = x.shape
        got = ek.lb_block(x, blk, bs)
        assert got.dtype == torch.int8
        rows = jnp.asarray(x.numpy().reshape(b * h * w, cin).astype(np.float32))
        out = np.asarray(jpallas.lb_block_pallas(
            rows, jblk["we"], jblk["be"], jblk["dw16"], jblk["wp"], h=h, w=w,
            s_expand=bs.s_expand, s_dw=bs.s_dw, s_project=bs.s_project,
            interpret=True)).reshape(b, h, w, -1)[:, ::bs.stride, ::bs.stride]
        np.testing.assert_array_equal(got.numpy().astype(np.float32), out)
        x = got


def test_kernel_path_refusals():
    """As in JAX: a stride-2 dense block is refused at parameter build, a
    block with non-power-of-two dims at the forward; the sim takes both."""
    rng = np.random.default_rng(13)
    q = _random_etiny(rng, dense_stride2=True)
    params, cfg = tsim.etiny_sim_params(q, device="cpu")
    with pytest.raises(ValueError, match="stride-2 dense"):
        ek.etiny_kernel_params(params, cfg)
    q = _random_etiny(rng)
    imgs = _images(rng, 2, h=24)  # blocks at 12x12, 6x6
    with pytest.raises(ValueError, match="powers of two"):
        _port_logits(q, imgs, ek.etiny_forward_kernel, kernel=True)
    assert _port_logits(q, imgs).shape == (2, 10)


def test_non_pow2_scale_refused():
    rng = np.random.default_rng(14)
    q = _random_etiny(rng)
    q.blocks[0].dw_scale = 48.0
    with pytest.raises(ValueError, match="power of two"):
        tsim.etiny_sim_params(q, device="cpu")
