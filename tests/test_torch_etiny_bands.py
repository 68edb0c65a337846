"""K6's row bands on the CPU: the band plan (`ops/etiny_kernels.py`
`band_plan`, `band_windows`, `rows_read`) for the 14 launch shapes of
EtinyNet-1.0 at 224×224 and for small odd sides at strides 1 and 2, each
band's rows stitched from the plain block on the band's input rows with
their halo and held to the whole block bit for bit; the `serve.kernels`
span's row counts; and the port's int8 serving path (`etinynet_quantize` →
`etiny_sim_params` → `etiny_forward_kernel`, its plain blocks here) held
to the benchmark's plain reference (`perfbench/reference/
etinynet_imagenet.py`) from the same float weights and calibrated
statistics, at 56×56 and at 224×224. Random weights from fixed seeds;
the file imports no jax.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nnue_vision_tpu_torch import tracing
from nnue_vision_tpu_torch.models.etinynet import (
    EtinyNet,
    EtinyNetConfig,
    etinynet_quantize,
)
from nnue_vision_tpu_torch.ops import etiny_kernels as ek
from nnue_vision_tpu_torch.ops.engine_sim import (
    EtinyBlockCfg,
    conv_out_hw,
    etiny_sim_params,
    lb_block_plain,
)
from perfbench import inputs
from perfbench.reference import augment as ref_aug
from perfbench.reference import etinynet_imagenet as ref


def _launch_shapes(side: int = 224):
    """(h, cin, mid, cout, stride) of the 13 blocks and the final 1×1 conv
    (the quantizer's 14th block) of EtinyNet-1.0 at `side`."""
    cfg = EtinyNetConfig(variant="1.0")
    h = (side - 1) // 2 + 1
    out = []
    for _, cin, mid, cout, stride, _ in cfg.block_specs():
        out.append((h, cin, mid, cout, stride))
        h = (h - 1) // stride + 1
    fin = cfg.table["final_channels"]
    out.append((h, out[-1][3], fin, fin, 1))
    return out


SHAPES_224 = _launch_shapes()
ODD = [(7, 16, 24, 16, 1), (7, 16, 24, 16, 2), (3, 8, 16, 8, 1),
       (3, 8, 16, 8, 2), (13, 8, 16, 8, 2), (14, 8, 16, 8, 2)]


def _block(gen, cin, mid, cout, stride):
    def i8(*s):
        return torch.randint(-127, 128, s, generator=gen, dtype=torch.int8)

    blk = {"pw_expand_w": i8(mid, cin),
           "pw_expand_b": torch.randint(-200000, 200000, (mid,), generator=gen,
                                        dtype=torch.int32),
           "dw_w": i8(mid, 3, 3), "pw_project_w": i8(cout, mid)}
    return blk, EtinyBlockCfg(stride=stride, s_expand=1024, s_dw=64,
                              s_project=4, is_dense=False)


def _stitched(x, blk, bs, rows):
    """The block's output built band by band, as the kernel's band path
    computes it: each band the plain block (at stride 1, its centers taken
    at the block's stride) on the band's input rows with their halo,
    keeping only its own output rows; and the input rows read."""
    s = bs.stride
    one = dataclasses.replace(bs, stride=1)
    parts, read = [], 0
    for oy0, oy1, iy0, iy1 in ek.band_windows(x.shape[1], s, rows):
        assert iy1 - iy0 <= ek.band_in_rows(rows, x.shape[1], s)
        y = lb_block_plain(x[:, iy0:iy1], blk, one)
        parts.append(y[:, [oy * s - iy0 for oy in range(oy0, oy1)]][:, :, ::s])
        read += iy1 - iy0
    return torch.cat(parts, dim=1), read


@pytest.mark.parametrize("h,cin,mid,cout,stride", SHAPES_224)
def test_band_plan_stitches_to_the_block_at_224(h, cin, mid, cout, stride):
    """The plan's band is the most rows that fit with 2 ring slots, taken
    only where one image does not fit; its bands stitch to the whole
    block, and `rows_read` counts the rows they read."""
    gen = torch.Generator().manual_seed(h * 1000 + cin + mid + stride)
    oh, ow = conv_out_hw(h, h, stride)
    rows = ek.band_plan(h, h, cin, mid, cout, stride)
    whole = ek.block_smem(1, h, h, cin, mid, cout, oh, ow)
    if rows == 0:
        assert whole <= ek.MAX_SMEM
        assert ek.rows_read(h, h, cin, mid, cout, stride) == h
        rows = 2  # the band arithmetic on a shape the tile path takes
    else:
        assert whole > ek.MAX_SMEM
        assert ek.block_smem(1, ek.band_in_rows(rows, h, stride), h, cin, mid,
                             cout, rows, ow) <= ek.MAX_SMEM
        assert rows == oh or ek.block_smem(
            1, ek.band_in_rows(rows + 1, h, stride), h, cin, mid, cout,
            rows + 1, ow) > ek.MAX_SMEM
    blk, bs = _block(gen, cin, mid, cout, stride)
    x = torch.randint(-127, 128, (1, h, h, cin), generator=gen, dtype=torch.int8)
    got, read = _stitched(x, blk, bs, rows)
    assert torch.equal(got, lb_block_plain(x, blk, bs))
    if ek.band_plan(h, h, cin, mid, cout, stride):
        assert read == ek.rows_read(h, h, cin, mid, cout, stride)


def test_nine_of_the_fourteen_launches_at_224_take_bands():
    """By hand: bands of 11, 44, 44, 44, 9, 25, 25, 25 and 8 output rows at
    sides 112, 56, 56, 56, 56, 28, 28, 28, 28; the rest whole images. The
    rows read: 117 + 3·58 + 59 + 3·30 + 29 + 3·14 + 2·7 = 525 of 504."""
    plan = [ek.band_plan(h, h, cin, mid, cout, s) for h, cin, mid, cout, s in SHAPES_224]
    assert plan == [11, 44, 44, 44, 9, 25, 25, 25, 8, 0, 0, 0, 0, 0]
    assert sum(h for h, *_ in SHAPES_224) == 504
    assert sum(ek.rows_read(h, h, *rest) for h, *rest in SHAPES_224) == 525


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("h,cin,mid,cout,stride", ODD)
def test_bands_of_odd_sides_stitch_to_the_block(h, cin, mid, cout, stride, rows):
    gen = torch.Generator().manual_seed(h * 100 + stride * 10 + rows)
    blk, bs = _block(gen, cin, mid, cout, stride)
    x = torch.randint(-127, 128, (3, h, h + 2, cin), generator=gen, dtype=torch.int8)
    got, read = _stitched(x, blk, bs, rows)
    assert torch.equal(got, lb_block_plain(x, blk, bs))
    oh = (h - 1) // stride + 1
    windows = ek.band_windows(h, stride, rows)
    assert len(windows) == -(-oh // rows) and windows[-1][1] == oh
    assert read >= h


def test_a_block_whose_one_row_does_not_fit_is_refused():
    with pytest.raises(ValueError, match="one output row"):
        ek.band_plan(8, 4096, 64, 64, 64, 1)


def _served(side: int, batch: int, seed: int):
    """The reference's and the port's int8 logits of `batch` seeded images
    from the same float weights and calibrated statistics."""
    cfg = {"variant": "1.0", "num_classes": 1000, "input_size": side,
           "dtype": "float32"}
    cpu = torch.device("cpu")
    weights = inputs.make_params(ref.param_specs(cfg), seed, cpu)
    calib = ref_aug.normalize(inputs.make_images(4, side, seed, "calibration", cpu))
    stats = ref.calibrate(weights, calib, cfg)
    x = ref_aug.normalize(inputs.make_images(batch, side, seed, "serving", cpu))
    want = ref.engine_forward(ref.quantize(weights, stats, cfg), x, cfg)
    model = EtinyNet(EtinyNetConfig(variant="1.0", num_classes=1000,
                                    input_size=side), device=cpu)
    model.load_state_dict({**weights, **stats}, strict=True)
    sim, scfg = etiny_sim_params(etinynet_quantize(model.eval()), device="cpu")
    kp = ek.etiny_kernel_params(sim, scfg)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = ek.etiny_forward_kernel(kp, x, cfg=scfg, image_h=side, image_w=side)
    spans = {s.name: s for s in tracing.spans()}
    return got, want, spans["serve.kernels"].counts, len(scfg.blocks)


@pytest.mark.parametrize("side,batch", [(56, 3), (224, 1)])
def test_port_serving_equals_the_reference(side, batch):
    got, want, counts, n_blocks = _served(side, batch, seed=2**31 + 21)
    assert n_blocks == 14
    assert got.shape == (batch, 1000) and torch.equal(got, want)
    assert float(got.std()) > 0  # the blocks did not round to zero
    sides = [h for h, *_ in _launch_shapes(side)]
    assert counts["rows"] == batch * sum(sides)
    if side == 224:
        assert counts["rows_read"] == batch * 525
    else:  # 28 down to 2: every block fits whole
        assert counts["rows_read"] == counts["rows"]


def test_row_counts_are_made_only_while_a_profiler_records(monkeypatch):
    """With no profiler the serving call computes no count (it would cost
    host time on every call); under one the counts are the plans'."""
    cfg = EtinyNetConfig(variant="micro", num_classes=10, input_size=20)
    model = EtinyNet(cfg, device="cpu")
    sim, scfg = etiny_sim_params(etinynet_quantize(model.eval()), device="cpu")
    kp = ek.etiny_kernel_params(sim, scfg)
    x = torch.rand((2, 20, 20, 3), generator=torch.Generator().manual_seed(3))
    want = ek.etiny_forward_kernel(kp, x, cfg=scfg, image_h=20, image_w=20)

    def refuse(*a):
        raise AssertionError("counted with no profiler")
    with monkeypatch.context() as m:
        m.setattr(ek, "_row_counts", refuse)
        got = ek.etiny_forward_kernel(kp, x, cfg=scfg, image_h=20, image_w=20)
    assert torch.equal(got, want)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ek.etiny_forward_kernel(kp, x, cfg=scfg, image_h=20, image_w=20)
    counts = [s.counts for s in tracing.spans() if s.name == "serve.kernels"]
    # the inputs of the micro model's 7 blocks and final conv: sides 10, 5,
    # 3, 3, 2, 2, 1, 1; every block takes whole images, each a launch of its
    # own at batch 2 (no run keeps 64 GEMM rows)
    assert counts == [{"rows": 2 * 27, "rows_read": 2 * 27, "k6_launches": 8,
                       "k6_narrow_products": 14}]


def test_the_reference_float_forward_follows_the_port():
    """The reference's float forward (eval, running statistics) against the
    port's EtinyNet-1.0 on the same weights and calibrated statistics."""
    cfg = {"variant": "1.0", "num_classes": 1000, "input_size": 56,
           "dtype": "float32"}
    cpu = torch.device("cpu")
    seed = 2**31 + 5
    weights = inputs.make_params(ref.param_specs(cfg), seed, cpu)
    calib = ref_aug.normalize(inputs.make_images(4, 56, seed, "calibration", cpu))
    stats = ref.calibrate(weights, calib, cfg)
    x = ref_aug.normalize(inputs.make_images(3, 56, seed, "serving", cpu))
    model = EtinyNet(EtinyNetConfig(variant="1.0", num_classes=1000,
                                    input_size=56), device=cpu)
    model.load_state_dict({**weights, **stats}, strict=True)
    with torch.no_grad():
        got = model.eval()(x)
        want = ref.forward(weights, stats, x, cfg, train=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(want.std()) > 0
