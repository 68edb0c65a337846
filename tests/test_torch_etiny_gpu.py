"""The EtinyNet LB-block Hopper kernel (K6) held bit-equal to the engine sim
on a card, per block and for the whole int8 forward, on a quantized
0.98M-width model, on a quantized 0.75-width engine_friendly model (LSQ
folds) and on random int models at full int8 ranges.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_etiny_gpu.py
"""

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.formats import (
    QConv,
    QLBBlock,
    QLinear,
    QuantizedEtinyNet,
)
from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.models.etinynet import (
    EtinyNetConfig,
    etinynet_init,
    etinynet_quantize,
)
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops.engine_sim import (
    etiny_engine_forward,
    etiny_sim_params,
    etiny_stem,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_model(rng, variant="0.98M"):
    """Random int8 weights and wide biases at the variant's widths, with the
    block strides the quantizer writes (stride-2 dense tagged as LB)."""
    cfg = EtinyNetConfig(variant=variant, num_classes=10, input_size=32)
    t = cfg.table

    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    blocks = [QLBBlock(pw_expand=i8(mid, cin), dw=i8(mid, 3, 3),
                       pw_project=i8(out, mid), stride=stride,
                       is_dense=dense and stride == 1,
                       pw_expand_bias=rng.integers(-200000, 200000, mid).astype(np.int32))
              for _, cin, mid, out, stride, dense in cfg.block_specs()]
    return QuantizedEtinyNet(
        variant=variant, num_classes=10, input_size=32,
        conv_channels=t["conv_channels"], final_channels=blocks[-1].out_channels,
        stem=QConv(weight=i8(t["conv_channels"], 3, 3, 3),
                   bias=rng.integers(-500, 500, t["conv_channels"]).astype(np.int32)),
        blocks=blocks,
        classifier=QLinear(weight=i8(10, blocks[-1].out_channels),
                           bias=rng.integers(-2000, 2000, 10).astype(np.int32)),
    ).validate()


def _quantized_model(cuda):
    cfg = EtinyNetConfig(variant="0.98M", num_classes=10, input_size=32)
    model = etinynet_init(cfg, torch.Generator().manual_seed(5), device=cuda).train()
    with torch.no_grad():
        model(normalize_images(torch.rand((64, 32, 32, 3), device=cuda)))
    return etinynet_quantize(model)


@pytest.mark.parametrize("batch", [1, 37, 1024])
@pytest.mark.parametrize("which", ["quantized", "random"])
def test_forward_equals_sim(cuda, which, batch):
    q = (_quantized_model(cuda) if which == "quantized"
         else _random_model(np.random.default_rng(batch)))
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = normalize_images(torch.rand((batch, 32, 32, 3), device=cuda)).contiguous()
    before = ek.LAUNCHES["etiny_block_kernel"]
    got = ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=32, image_w=32)
    assert ek.LAUNCHES["etiny_block_kernel"] == before + len(cfg.blocks)
    want = etiny_engine_forward(sim, x, cfg=cfg, image_h=32, image_w=32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _ef_quantized_model(cuda):
    """A 0.75-width engine_friendly model with LSQ scales in [0.5, 1.5] and
    running statistics settled by 40 training-mode forwards (with fewer,
    the last blocks' int8 outputs are all zero), quantized with the LSQ
    folds (the final block's projection diag(64·s3))."""
    cfg = EtinyNetConfig(variant="0.75", num_classes=10, input_size=32,
                         engine_friendly=True)
    gen = torch.Generator().manual_seed(6)
    model = etinynet_init(cfg, gen, device=cuda).train()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "qlog" in name:
                p.copy_(torch.rand(p.shape, generator=gen) * 1.1 - 0.7)
        for _ in range(40):
            model(normalize_images(torch.rand((64, 32, 32, 3), device=cuda)))
    return etinynet_quantize(model)


@pytest.mark.parametrize("batch", [37, 1024])
def test_ef_forward_equals_sim(cuda, batch):
    """K6 on an engine_friendly `.etiny`: 12 launches (11 LB blocks and the
    synthetic final block) equal to the engine sim."""
    q = _ef_quantized_model(cuda)
    proj = q.blocks[-1].pw_project
    assert len(q.blocks) == 12 and len(set(np.diag(proj).tolist())) > 1
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = normalize_images(torch.rand((batch, 32, 32, 3), device=cuda)).contiguous()
    before = ek.LAUNCHES["etiny_block_kernel"]
    got = ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=32, image_w=32)
    assert ek.LAUNCHES["etiny_block_kernel"] == before + 12
    want = etiny_engine_forward(sim, x, cfg=cfg, image_h=32, image_w=32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(got.std(dim=0).max()) > 0  # the logits depend on the image


def test_each_block_equals_plain(cuda):
    q = _random_model(np.random.default_rng(7))
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = normalize_images(torch.rand((64, 32, 32, 3), device=cuda)) * 4
    a = etiny_stem(kp, x, cfg).to(torch.int8)
    for blk, bs in zip(kp["blocks"], cfg.blocks):
        got = ek.lb_block(a, blk, bs)
        want = ek.lb_block_reference(a, blk, bs)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        a = got


def test_refusals_on_the_card(cuda):
    q = _random_model(np.random.default_rng(8), variant="micro")
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = torch.zeros((2, 24, 24, 3), device=cuda)
    with pytest.raises(ValueError, match="powers of two"):
        ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=24, image_w=24)
    blk = dict(kp["blocks"][0], we=kp["blocks"][0]["we"].float())
    a = torch.zeros((2, 16, 16, q.conv_channels), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="we"):
        ek.lb_block(a, blk, cfg.blocks[0])
