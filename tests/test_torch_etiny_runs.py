"""K6's runs on the CPU: the run plan (`ops/etiny_kernels.py` `run_plan`,
`run_smem`, `block_tile`) for EtinyNet-0.98M at batches 1, 37 and 8192,
EtinyNet-1.0 at 224×224 and batch 1024 and EtinyNet-micro: every block
once and in order, a band block alone, every run within shared memory by
the mirrored layout with at least 64 GEMM rows in each of its products
and a tile that fills the SMs, a run of one block the single-block
launch; the layout worked by hand for the 0.98M's first run; and the
`serve.kernels` span's `k6_launches` and `k6_narrow_products` (EtinyNet-1.0
at 224, 0.98M and 0.75 at 32, a model of wide blocks). The run kernel
itself runs only on a card (`tests/test_torch_etiny_gpu.py`). The file
imports no jax.
"""

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
from nnue_vision_tpu_torch.ops.engine_sim import conv_out_hw, etiny_sim_params


def _shapes(variant: str, side: int):
    """(h, w, cin, mid, cout, stride) of the quantizer's blocks (the LB
    blocks and the final 1×1 conv) of `variant` at `side`."""
    cfg = EtinyNetConfig(variant=variant)
    specs = [(cin, mid, out, s) for _, cin, mid, out, s, _ in cfg.block_specs()]
    fin = cfg.table["final_channels"]
    specs.append((specs[-1][2], fin, fin, 1))
    h = (side - 1) // 2 + 1
    return ek.block_shapes(tuple(specs), h, h)


CASES = [("0.98M", 32, 1), ("0.98M", 32, 37), ("0.98M", 32, 8192),
         ("1.0", 224, 1024), ("micro", 32, 8192), ("micro", 32, 5)]


@pytest.mark.parametrize("variant,side,batch", CASES)
def test_the_plan_covers_every_block_once_in_order(variant, side, batch):
    shapes = _shapes(variant, side)
    plan = ek.run_plan(shapes, batch)
    assert plan[0].first == 0
    for a, b in zip(plan, plan[1:]):
        assert b.first == a.first + a.count
    assert plan[-1].first + plan[-1].count == len(shapes)
    assert all(1 <= r.count <= ek.MAX_RUN for r in plan)


@pytest.mark.parametrize("variant,side,batch", CASES)
def test_a_band_block_runs_alone(variant, side, batch):
    shapes = _shapes(variant, side)
    for r in ek.run_plan(shapes, batch):
        bands = [ek.band_plan(*s) for s in shapes[r.first:r.first + r.count]]
        if any(bands):
            assert r.count == 1 and r.band == bands[0]
        else:
            assert r.band == 0


@pytest.mark.parametrize("variant,side,batch", CASES)
def test_every_run_fits_and_keeps_its_rows(variant, side, batch):
    """A run of several blocks fits with 2 ring slots, gives each of its
    products at least 64 GEMM rows, takes no more images a tile than fill
    the SMs, and no fewer than its first block alone would."""
    shapes = _shapes(variant, side)
    fill = -(-batch // ek.H100_SMS)
    for r in ek.run_plan(shapes, batch):
        if r.count == 1:
            continue
        part = shapes[r.first:r.first + r.count]
        assert ek.run_smem(r.tile, part) <= ek.MAX_SMEM
        assert r.tile <= fill
        h, w, cin, mid, cout, s = part[0]
        assert r.tile >= ek.block_tile(batch, h, w, cin, mid, cout,
                                       *conv_out_hw(h, w, s))
        for h, w, _, _, _, s in part:
            oh, ow = conv_out_hw(h, w, s)
            assert r.tile * oh * ow >= 64 and r.tile * h * w >= 64


@pytest.mark.parametrize("variant,side,batch", CASES)
def test_a_run_of_one_is_the_single_block_launch(variant, side, batch):
    shapes = _shapes(variant, side)
    for r in ek.run_plan(shapes, batch):
        if r.count != 1:
            continue
        h, w, cin, mid, cout, s = shapes[r.first]
        band = ek.band_plan(h, w, cin, mid, cout, s)
        assert r.band == band
        if not band:
            assert r.tile == ek.block_tile(batch, h, w, cin, mid, cout,
                                           *conv_out_hw(h, w, s))


def test_the_plans_by_hand():
    """0.98M at 8192: b0-b5 at 4 images a tile (the 4×4 blocks' 16
    positions), b6-b8 at 16 (their 2×2 outputs), then b9, b10 and the
    final block alone (a 1×1 output needs 64 images, past ⌈8192/132⌉ =
    63). At 37 only b0-b2 fuse, at 1 image a tile (8×8 = 64 rows). At 224
    the nine band blocks run alone and the two 14×14 blocks fuse."""
    plan = ek.run_plan(_shapes("0.98M", 32), 8192)
    assert [(r.first, r.count, r.tile) for r in plan] == [
        (0, 6, 4), (6, 3, 16), (9, 1, 63), (10, 1, 63), (11, 1, 63)]
    plan = ek.run_plan(_shapes("0.98M", 32), 37)
    assert [(r.first, r.count, r.tile) for r in plan][:2] == [(0, 3, 1), (3, 1, 1)]
    assert len(plan) == 10
    plan = ek.run_plan(_shapes("1.0", 224), 1024)
    assert [r.count for r in plan] == [1] * 9 + [2, 1, 1, 1]
    assert sum(bool(r.band) for r in plan) == 9


def test_the_run_layout_by_hand():
    """0.98M's b0-b5 at 4 images: region P holds b0's input, 1024 rows of
    48 bytes and the slack (49,280); region Q b0's expansion, 1024 × 28
    (28,672); the six blocks' biases and depthwise weights 3 × 384 + 3 ×
    1,536; every product is one stage, so one ring slot of 18,432."""
    part = _shapes("0.98M", 32)[:6]
    assert ek.run_smem(4, part) == 49280 + 28672 + 5760 + 18432
    # more slots change nothing where every product has one stage
    assert ek.run_smem(4, part, slots=8) == ek.run_smem(4, part)


def test_the_span_counts_the_plans_launches():
    """`k6_launches`, from the plan: the micro model's 8 blocks at 20×20
    and batch 2 (sides 10 down to 1; nothing fuses at one image a tile
    except where 64 rows remain: 10×10 → 5×5 does not)."""
    cfg = EtinyNetConfig(variant="micro", num_classes=10, input_size=20)
    model = EtinyNet(cfg, device="cpu")
    sim, scfg = etiny_sim_params(etinynet_quantize(model.eval()), device="cpu")
    kp = ek.etiny_kernel_params(sim, scfg)
    x = torch.rand((2, 20, 20, 3), generator=torch.Generator().manual_seed(3))
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ek.etiny_forward_kernel(kp, x, cfg=scfg, image_h=20, image_w=20)
    counts = [s.counts for s in tracing.spans() if s.name == "serve.kernels"]
    plan = ek.run_plan(ek.block_shapes(kp["k6_specs"], 10, 10), 2)
    assert counts[0]["k6_launches"] == len(plan) == 8
    # every product of the micro model's 7 LB blocks has at most 32
    # columns; the final 1x1 conv's two have 128
    assert counts[0]["k6_narrow_products"] == 14


@pytest.mark.parametrize("variant,side,batch,narrow", [
    ("1.0", 224, 1024, 8), ("0.98M", 32, 8192, 6), ("0.75", 32, 8192, 6),
    ("wide", 32, 8192, 0)])
def test_narrow_products_from_the_plans(variant, side, batch, narrow):
    """`k6_narrow_products` of the `serve.kernels` span's counts, from the
    shapes at the plan's batch: EtinyNet-1.0 at 224 (b0-b3, four 32-channel
    blocks on bands, two products each), 0.98M and 0.75 at 32 (b0-b2
    inside the first run, 28 and 24 channels), and a model whose every
    product is wider than 32 columns."""
    if variant == "wide":
        specs = ((48, 64, 48, 2), (48, 96, 64, 1), (64, 128, 64, 2))
    else:
        specs = tuple((cin, mid, cout, s) for _, _, cin, mid, cout, s
                      in _shapes(variant, side))
    h = (side - 1) // 2 + 1
    x = torch.empty((batch, h, h, specs[0][0]), dtype=torch.int8, device="meta")
    counts = ek._row_counts({"k6_specs": specs}, x)
    assert counts["k6_narrow_products"] == narrow
    shapes = ek.block_shapes(specs, h, h)
    plan = ek.run_plan(shapes, batch)
    assert narrow == sum(ek.narrow_products(shapes[r.first:r.first + r.count])
                         for r in plan)
