"""The EtinyNet LB-block Hopper kernel (K6) held bit-equal to the engine sim
on a card, per block and for the whole int8 forward, on a quantized
0.98M-width model, on a quantized 0.75-width engine_friendly model (LSQ
folds) and on random int models at full int8 ranges; EtinyNet-1.0 at
224×224 and at odd sides, whose large blocks take K6's row bands; the
wrapper's shared-memory plan against the library's.

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


def _random_model(rng, variant="0.98M", final=False):
    """Random int8 weights and wide biases at the variant's widths, with the
    block strides the quantizer writes (stride-2 dense tagged as LB);
    `final` adds the quantizer's last block, the 1×1 conv to the final
    channels."""
    cfg = EtinyNetConfig(variant=variant, num_classes=10, input_size=32)
    t = cfg.table

    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    specs = [(cin, mid, out, stride, dense)
             for _, cin, mid, out, stride, dense in cfg.block_specs()]
    if final:
        specs.append((specs[-1][2], t["final_channels"], t["final_channels"], 1,
                      False))
    blocks = [QLBBlock(pw_expand=i8(mid, cin), dw=i8(mid, 3, 3),
                       pw_project=i8(out, mid), stride=stride,
                       is_dense=dense and stride == 1,
                       pw_expand_bias=rng.integers(-200000, 200000, mid).astype(np.int32))
              for cin, mid, out, stride, dense in specs]
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
    """Sides that are not powers of two equal the sim; a weight of the
    wrong dtype is refused."""
    q = _random_model(np.random.default_rng(8), variant="micro")
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = normalize_images(torch.rand((2, 24, 24, 3), device=cuda)) * 4
    got = ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=24, image_w=24)
    want = etiny_engine_forward(sim, x, cfg=cfg, image_h=24, image_w=24)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    blk = dict(kp["blocks"][0], we=kp["blocks"][0]["we"].float())
    a = torch.zeros((2, 16, 16, q.conv_channels), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="we"):
        ek.lb_block(a, blk, cfg.blocks[0])


@pytest.mark.parametrize("side", [27, 45, 63])
def test_odd_sides_equal_sim(cuda, side):
    """Odd sides on the tile path: the micro model's blocks at sides 14, 7,
    4, 2, 1 (27), 23, 12, 6, 3, 2 (45) and 32, 16, 8, 4, 2 (63)."""
    q = _random_model(np.random.default_rng(side), variant="micro", final=True)
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = normalize_images(torch.rand((37, side, side, 3), device=cuda)) * 4
    got = ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=side, image_w=side)
    want = etiny_engine_forward(sim, x, cfg=cfg, image_h=side, image_w=side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _blocks_equal_plain(kp, cfg, x):
    """Each K6 launch on the input the launch before it made, against the
    plain block; returns the launches and band launches made."""
    before = dict(ek.LAUNCHES)
    a = etiny_stem(kp, x, cfg).to(torch.int8)
    for i, (blk, bs) in enumerate(zip(kp["blocks"], cfg.blocks)):
        got = ek.lb_block(a, blk, bs)
        want = ek.lb_block_reference(a, blk, bs)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"block {i} at {tuple(a.shape)}"
        a = got
    return (ek.LAUNCHES["etiny_block_kernel"] - before["etiny_block_kernel"],
            ek.LAUNCHES["band_launches"] - before["band_launches"])


@pytest.mark.parametrize("batch,side", [(1, 224), (37, 224), (1024, 224), (3, 218)])
def test_etinynet_1_0_at_imagenet_size(cuda, batch, side):
    """EtinyNet-1.0's 13 blocks and final 1×1 conv: 14 launches, 9 of them
    on row bands at 224 (the blocks at 112, 56 and 28; at 218 the sides
    are 109, 55, 28, 14, 7); each launch equal to the plain block, the
    logits to the sim. Batch 37 leaves a ragged last tile."""
    q = _random_model(np.random.default_rng(batch + side), variant="1.0",
                      final=True)
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    gen = torch.Generator(device=cuda).manual_seed(batch)
    x = normalize_images(torch.rand((batch, side, side, 3), generator=gen,
                                    device=cuda)).contiguous()
    launches, bands = _blocks_equal_plain(kp, cfg, x)
    assert launches == 14 and bands == 9
    before = dict(ek.LAUNCHES)
    got = ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=side, image_w=side)
    assert ek.LAUNCHES["etiny_block_kernel"] == before["etiny_block_kernel"] + 14
    assert ek.LAUNCHES["band_launches"] == before["band_launches"] + 9
    want = etiny_engine_forward(sim, x, cfg=cfg, image_h=side, image_w=side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_shared_memory_plan_equals_the_library(cuda):
    """The wrapper's copy of the kernel's shared-memory layout
    (`block_smem`, from which `band_plan` picks the band) against the
    library's `etiny_block_smem`, on the tile shapes of the 0.98M and 1.0
    models and on the bands the plan picks at 224."""
    from nnue_vision_tpu_torch.ops._build import load_library

    lib = load_library().lib
    shapes = []
    for variant, side in (("0.98M", 32), ("1.0", 224)):
        specs = [(cin, mid, out, s) for _, cin, mid, out, s, _
                 in EtinyNetConfig(variant=variant).block_specs()]
        fin = EtinyNetConfig(variant=variant).table["final_channels"]
        specs.append((specs[-1][2], fin, fin, 1))
        h = (side - 1) // 2 + 1
        for cin, mid, out, s in specs:
            oh = (h - 1) // s + 1
            rows = ek.band_plan(h, h, cin, mid, out, s)
            for tile in (1, 2, 7):
                shapes.append((tile, h, h, cin, mid, out, oh, oh))
            if rows:
                shapes.append((1, ek.band_in_rows(rows, h, s), h, cin, mid, out,
                               rows, oh))
            h = oh
    for shape in shapes:
        assert ek.block_smem(*shape) == lib.etiny_block_smem(*shape), shape
