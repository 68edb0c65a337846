"""The EtinyNet LB-block Hopper kernel (K6) held bit-equal to the engine sim
on a card, per block and for the whole int8 forward (with the stem and
tail kernels, one launch each a call), on a quantized
0.98M-width model, on a quantized 0.75-width engine_friendly model (LSQ
folds) and on random int models at full int8 ranges; EtinyNet-1.0 at
224×224 and at odd sides, whose large blocks take K6's row bands; single
launches of random blocks on bands and tiles, on both warp layouts and both
depthwise paths, against the plain block; the run launches of `run_plan` against the chain of single-block launches and
the sim; the wrapper's shared-memory plans and tiles against the
library's.

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
    EtinyBlockCfg,
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


def _one_stem_and_tail(before):
    """The forward since the `before` counts launched the stem and the tail
    kernel once each."""
    for name in ("etiny_stem_kernel", "etiny_tail_kernel"):
        assert ek.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.parametrize("batch", [1, 37, 1024])
@pytest.mark.parametrize("which", ["quantized", "random"])
def test_forward_equals_sim(cuda, which, batch):
    q = (_quantized_model(cuda) if which == "quantized"
         else _random_model(np.random.default_rng(batch)))
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = normalize_images(torch.rand((batch, 32, 32, 3), device=cuda)).contiguous()
    before = dict(ek.LAUNCHES)
    got = ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=32, image_w=32)
    assert ek.LAUNCHES["etiny_block_kernel"] == before["etiny_block_kernel"] + len(
        _plan(kp, batch, 32))
    _one_stem_and_tail(before)
    want = etiny_engine_forward(sim, x, cfg=cfg, image_h=32, image_w=32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _plan(kp, batch, side):
    """`run_plan` of the model's blocks for `batch` images of `side`."""
    h = (side - 1) // 2 + 1
    return ek.run_plan(ek.block_shapes(kp["k6_specs"], h, h), batch,
                       ek.sm_count(torch.cuda.current_device()))


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
    """K6 on an engine_friendly `.etiny` (11 LB blocks and the synthetic
    final block), one launch per run of the plan, equal to the engine
    sim."""
    q = _ef_quantized_model(cuda)
    proj = q.blocks[-1].pw_project
    assert len(q.blocks) == 12 and len(set(np.diag(proj).tolist())) > 1
    sim, cfg = etiny_sim_params(q, device=cuda)
    kp = ek.etiny_kernel_params(sim, cfg)
    x = normalize_images(torch.rand((batch, 32, 32, 3), device=cuda)).contiguous()
    before = dict(ek.LAUNCHES)
    got = ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=32, image_w=32)
    assert ek.LAUNCHES["etiny_block_kernel"] == before["etiny_block_kernel"] + len(
        _plan(kp, batch, 32))
    _one_stem_and_tail(before)
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


def _one_block(gen, cin, mid, cout, stride, dev):
    """A block of random int8 weights and wide biases in the layouts of
    `etiny_kernel_params`, its scales chosen so that the expansion, the
    depthwise and the projection each reach values inside their clamps."""
    def i8(*s):
        return torch.randint(-127, 128, s, generator=gen, dtype=torch.int8).to(dev)

    we, dw, wp = i8(mid, cin), i8(mid, 3, 3), i8(cout, mid)
    be = torch.randint(-20000, 20000, (mid,), generator=gen, dtype=torch.int32).to(dev)
    blk = {"pw_expand_w": we, "pw_expand_b": be, "dw_w": dw, "pw_project_w": wp,
           "we": ek.mma_tiles(we), "be": be.contiguous(), "dw": dw.contiguous(),
           "wp": ek.mma_tiles(wp)}
    return blk, EtinyBlockCfg(stride=stride, s_expand=4096, s_dw=128,
                              s_project=16, is_dense=False)


# (batch, h, w, cin, mid, cout, stride, band rows the plan gives); the
# narrow layout takes a product of at most 32 columns
ONE_LAUNCH = [
    (3, 112, 112, 32, 32, 32, 2, 11),   # EtinyNet-1.0's b0 at 224: both narrow
    (3, 56, 56, 32, 32, 32, 1, 44),     # its b1-b3, a short last band (12)
    (3, 28, 28, 128, 128, 128, 1, 25),  # its b5-b7: both wide, last band 3
    (3, 56, 56, 32, 96, 24, 1, 17),     # cout <= 32 < mid: narrow project
    (37, 8, 8, 32, 96, 24, 1, 0),       # the same on the tile path
    (3, 56, 56, 28, 30, 28, 1, 46),     # mid % 4 != 0: the one-channel depthwise
    (3, 56, 56, 32, 34, 24, 2, 22),     # the same with a wide expansion
    (3, 109, 109, 32, 32, 32, 2, 11),   # b0 at 218: an odd side
    (3, 55, 55, 32, 32, 32, 1, 45),     # b1 at 218: odd, a short last band
    (3, 57, 57, 30, 32, 32, 2, 22),     # cin % 4 != 0: the input a byte a time
]


@pytest.mark.parametrize("batch,h,w,cin,mid,cout,stride,band", ONE_LAUNCH)
def test_one_launch_equals_the_plain_block(cuda, batch, h, w, cin, mid, cout, stride,
                                           band):
    """A single-block launch, on row bands or on tiles, torch.equal to the
    plain block, on both warp layouts and both depthwise paths."""
    gen = torch.Generator().manual_seed(h * 1000 + cin + mid + cout + stride)
    blk, bs = _one_block(gen, cin, mid, cout, stride, cuda)
    assert ek.band_plan(h, w, cin, mid, cout, stride) == band
    x = torch.randint(-127, 128, (batch, h, w, cin), generator=gen,
                      dtype=torch.int8).to(cuda)
    before = dict(ek.LAUNCHES)
    got = ek.lb_block(x, blk, bs)
    assert ek.LAUNCHES["band_launches"] - before["band_launches"] == int(band > 0)
    want = ek.lb_block_reference(x, blk, bs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(want.float().std()) > 0  # the scales kept values apart


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
    """EtinyNet-1.0's 13 blocks and final 1×1 conv: 14 single-block
    launches, 9 of them on row bands at 224 (the blocks at 112, 56 and 28;
    at 218 the sides are 109, 55, 28, 14, 7), each equal to the plain
    block; the forward's launches, one per run of the plan with the same 9
    on bands, give the sim's logits. Batch 37 leaves a ragged last
    tile."""
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
    assert ek.LAUNCHES["etiny_block_kernel"] == before["etiny_block_kernel"] + len(
        _plan(kp, batch, side))
    assert ek.LAUNCHES["band_launches"] == before["band_launches"] + 9
    _one_stem_and_tail(before)
    want = etiny_engine_forward(sim, x, cfg=cfg, image_h=side, image_w=side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _model_params(cuda, model):
    """(kparams, sim, cfg, side) of a test model: a random 0.98M, the
    quantized engine_friendly 0.75 at 32×32, or a random 1.0 at 224."""
    if model == "0.98M":
        q, side = _random_model(np.random.default_rng(11), final=True), 32
    elif model == "ef 0.75":
        q, side = _ef_quantized_model(cuda), 32
    else:
        q, side = _random_model(np.random.default_rng(12), variant="1.0",
                                final=True), 224
    sim, cfg = etiny_sim_params(q, device=cuda)
    return ek.etiny_kernel_params(sim, cfg), sim, cfg, side


@pytest.mark.parametrize("model,batch", [
    (model, batch) for model in ("0.98M", "ef 0.75")
    for batch in (1, 37, 1024, 2050, 8192)] + [
    ("1.0 at 224", batch) for batch in (1, 37, 1024)])
def test_runs_equal_the_chain_and_the_sim(cuda, model, batch):
    """The forward's launches, one per run of `run_plan`, against the chain
    of single-block launches and the sim's blocks (each run's output) and
    the sim's logits. At 2050 both fused runs of the 0.98M and 0.75 models
    (tiles of 4 and 16) end on a ragged tile. The 1.0 model at 224 stops at
    batch 1024 (its int64 sim at 8192 would hold 3.3 GB a block's input)."""
    kp, sim, cfg, side = _model_params(cuda, model)
    gen = torch.Generator(device=cuda).manual_seed(batch)
    x = normalize_images(torch.rand((batch, side, side, 3), generator=gen,
                                    device=cuda)).contiguous()
    if model != "ef 0.75":
        x = x * 4  # the random weights' activations away from zero
    plan = _plan(kp, batch, side)
    assert [r.first for r in plan] == list(
        np.cumsum([0] + [r.count for r in plan[:-1]]))
    a = etiny_stem(kp, x, cfg).to(torch.int8)
    before = dict(ek.LAUNCHES)
    fused = ek.lb_blocks(a, kp, cfg)
    assert ek.LAUNCHES["etiny_block_kernel"] - before["etiny_block_kernel"] == len(plan)
    assert ek.LAUNCHES["run_launches"] - before["run_launches"] == sum(
        r.count > 1 for r in plan)
    chain = plain = a
    for blk, bs in zip(kp["blocks"], cfg.blocks):
        chain = ek.lb_block(chain, blk, bs)
        plain = ek.lb_block_reference(plain, blk, bs)
    torch.cuda.synchronize()
    assert torch.equal(fused, chain) and torch.equal(fused, plain)
    got = ek.etiny_forward_kernel(kp, x, cfg=cfg, image_h=side, image_w=side)
    want = etiny_engine_forward(sim, x, cfg=cfg, image_h=side, image_w=side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if side == 32:  # the blocks did not round to zero
        assert float(fused.float().std()) > 0


def test_shared_memory_plan_equals_the_library(cuda):
    """The wrapper's copy of the kernel's shared-memory layout
    (`block_smem`, from which `band_plan` picks the band) against the
    library's `etiny_block_smem`, on the tile shapes of the 0.98M and 1.0
    models and on the bands the plan picks at 224; the run layout
    (`run_smem`) against `etiny_run_smem` on every run the plan makes at
    batches 1, 37, 1024 and 8192 and at tiles 1 to 64; the single-block
    tile (`block_tile`) against `etiny_block_tile`; and the widest product
    that `narrow_products` counts (`NARROW`) against the kernel's
    `etiny_narrow_columns`."""
    import ctypes

    from nnue_vision_tpu_torch.ops._build import load_library

    lib = load_library().lib
    assert ek.NARROW == lib.etiny_narrow_columns()
    sms = ek.sm_count(torch.cuda.current_device())
    for variant, side in (("0.98M", 32), ("0.75", 32), ("1.0", 224), ("micro", 32)):
        cfg = EtinyNetConfig(variant=variant)
        specs = [(cin, mid, out, s) for _, cin, mid, out, s, _ in cfg.block_specs()]
        fin = cfg.table["final_channels"]
        specs.append((specs[-1][2], fin, fin, 1))
        shapes = ek.block_shapes(tuple(specs), (side - 1) // 2 + 1, (side - 1) // 2 + 1)
        runs = {(r.first, r.count) for batch in (1, 37, 1024, 8192)
                for r in ek.run_plan(shapes, batch, sms) if r.count > 1}
        assert runs, variant
        for first, count in runs:
            part = shapes[first:first + count]
            for tile in (1, 2, 4, 16, 64):
                words = [tile, count] + [v for shape in part for v in shape]
                got = lib.etiny_run_smem((ctypes.c_int64 * len(words))(*words))
                assert ek.run_smem(tile, part) == got, (variant, part, tile)
        for h, w, cin, mid, cout, s in shapes:
            oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
            if ek.band_plan(h, w, cin, mid, cout, s):
                continue
            for batch in (1, 37, 1024, 8192):
                assert ek.block_tile(batch, h, w, cin, mid, cout, oh, ow, sms) == \
                    lib.etiny_block_tile(batch, h, w, cin, mid, cout, oh, ow)
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
