"""The profiling probes' kernels held bit-equal to their plain versions on a
card: the cut mega kernel (K7) at every level, with both threshold signs,
and the single warp pass with and without its gather (`lerp_pass`, K8's
`nogather_pass`); the CUDA-graph timing harness, scalar-chained too; and
the ten probes ported from `scripts/`: each kernel stage (K1, K2, K6, K4 and
K5 in the tiers, the bf16 tensor-core conv) against its plain stage on the
same inputs, and every training probe's graphs captured and replayed at a
small size.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_probes_gpu.py
"""

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.formats import (
    QConv,
    QFeatureTransformer,
    QLinear,
    QuantizedNNUE,
)
from nnue_vision_tpu_torch.ops import _ring
from nnue_vision_tpu_torch.ops import nnue_kernels as nk
from nnue_vision_tpu_torch.ops import warp_kernel as wk
from nnue_vision_tpu_torch.ops.engine_sim import nnue_sim_params
from nnue_vision_tpu_torch import (
    profile_batched_draws,
    profile_etiny_pallas,
    profile_etiny_roofline,
    profile_etiny_train,
    profile_heavy_aug,
    profile_nnue_split,
    profile_photometric_rng,
    profile_scaled_train,
    profile_train_roofline,
    profile_train_sweep,
)
from nnue_vision_tpu_torch.data import augment as aug
from nnue_vision_tpu_torch.models.etinynet import EtinyNetConfig
from nnue_vision_tpu_torch.models.nnue import GridFeatureSet, NNUEConfig
from nnue_vision_tpu_torch.ops.timing import chained_best_ms, scalar_chained_best_ms

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(rng, thresh, grid=10, ch=8, l1=1024, l2=128, l3=32, nc=10):
    """Random valid integers at the flagship widths, int16 FT weights wide
    enough that the FT sums wrap."""
    def i8(*s):
        return rng.integers(-127, 128, s).astype(np.int8)

    def i32(*s, lo=-2000, hi=2000):
        return rng.integers(lo, hi, s).astype(np.int32)

    f = grid * grid * ch
    return QuantizedNNUE(
        grid_size=grid, num_features_per_square=ch, l1=l1, l2=l2, l3=l3,
        nnue2score=600.0, visual_threshold=thresh,
        conv=QConv(weight=i8(ch, 3, 3, 3), bias=i32(ch, lo=-500, hi=500)),
        ft=QFeatureTransformer(
            weight=rng.integers(-30000, 30000, (f, l1)).astype(np.int16),
            bias=i32(l1)),
        fc1=QLinear(weight=i8(l2, l1), bias=i32(l2)),
        fc2=QLinear(weight=i8(l3, l2), bias=i32(l3)),
        out=QLinear(weight=i8(nc, l3), bias=i32(nc)),
    ).validate()


@pytest.mark.parametrize("thresh", [0.1, -0.25], ids=["positive", "negative"])
@pytest.mark.parametrize("batch", [8192, 37])
def test_stage_kernel_equals_plain_at_every_level(cuda, thresh, batch):
    sim, cfg = nnue_sim_params(_model(np.random.default_rng(3), thresh),
                               device=cuda)
    head = nk.mega_head_params(sim, cfg, 32, 32)
    gen = torch.Generator(device=cuda).manual_seed(batch)
    x = normalize_images(torch.rand((batch, 32, 32, 3), generator=gen,
                                    device=cuda)).reshape(batch, -1)
    nk.reset_launch_counts()
    for level in range(len(nk.STAGES)):
        kw = dict(cfg=cfg, image_h=32, image_w=32, level=level)
        got = nk.nnue_mega_stage(head, x, **kw)
        assert got.shape == (batch, nk.STAGE_OUT) and got.device.type == "cuda"
        assert torch.equal(got, nk.nnue_mega_stage_reference(head, x, **kw))
    assert nk.LAUNCHES["nnue_mega_stage_kernel"] == len(nk.STAGES)
    # the serving kernel (level 4) is untouched by the cut
    kw = dict(cfg=cfg, image_h=32, image_w=32)
    full = nk.nnue_engine_forward_mega(head, x, **kw)
    ref = nk.nnue_engine_forward_mega_reference(head, x, **kw)
    assert all(torch.equal(g, r) for g, r in zip(full, ref))


@pytest.mark.parametrize("batch", [1024, 37])
def test_passes_equal_plain(cuda, batch):
    rng = np.random.default_rng(batch)
    x = torch.from_numpy(rng.random((batch, 32, 96), dtype=np.float32)).to(cuda)
    # positions in and out of [0, 32): rows and lanes scaled, shifted
    coef = torch.from_numpy(np.stack([
        rng.uniform(-0.5, 0.5, batch), rng.uniform(-1.3, 1.3, batch),
        rng.uniform(-20.0, 40.0, batch)], 1).astype(np.float32)).to(cuda)
    wk.reset_launch_counts()
    for fn, ref in ((wk.lerp_pass, wk.lerp_pass_reference),
                    (wk.nogather_pass, wk.nogather_pass_reference)):
        got = fn(x, coef, n=32, c=3)
        assert got.device.type == "cuda"
        assert torch.equal(got, ref(x, coef, n=32, c=3))
    assert wk.LAUNCHES["lerp_pass_kernel"] == 1
    assert wk.LAUNCHES["nogather_pass_kernel"] == 1


def test_chained_best_ms_replays_a_graph(cuda):
    x = torch.rand((64, 32, 96), device=cuda)
    coef = torch.zeros((64, 3), device=cuda)
    coef[:, 1] = 1.0  # identity positions
    wk.reset_launch_counts()
    ms = chained_best_ms(lambda: wk.lerp_pass(x, coef, n=32, c=3), reps=5)
    assert ms > 0
    assert wk.LAUNCHES["lerp_pass_kernel"] == 1 + 5  # warm-up + captured


@pytest.mark.parametrize("n,rows", [(32, 32), (32, 33), (16, 16), (16, 21)])
@pytest.mark.parametrize("batch", [1, 37, 131, 133, 1024])
@pytest.mark.parametrize("grid", [None, 132, 1], ids=["occupancy", "132", "1"])
def test_passes_at_ragged_tiles(cuda, monkeypatch, n, rows, batch, grid):
    """The single pass and K8 where the row count is not a multiple of the
    tile (32 rows at n = 32, 64 at n = 16), on every grid size."""
    if grid is not None:
        monkeypatch.setattr(_ring, "grid", lambda dev, items, *shape: min(items, grid))
    rng = np.random.default_rng(n * rows + batch)
    x = torch.from_numpy(rng.random((batch, rows, n * 3), dtype=np.float32)).to(cuda)
    coef = torch.from_numpy(np.stack([
        rng.uniform(-0.5, 0.5, batch), rng.uniform(-1.3, 1.3, batch),
        rng.uniform(-0.6 * n, 1.2 * n, batch)], 1).astype(np.float32)).to(cuda)
    for fn, ref in ((wk.lerp_pass, wk.lerp_pass_reference),
                    (wk.nogather_pass, wk.nogather_pass_reference)):
        got = fn(x, coef, n=n, c=3)
        torch.cuda.synchronize()
        assert torch.equal(got, ref(x, coef, n=n, c=3))


def test_scalar_chained_best_ms_replays_a_graph(cuda):
    x = torch.rand((64, 32, 96), device=cuda)
    coef = torch.zeros((64, 3), device=cuda)
    coef[:, 1] = 1.0
    wk.reset_launch_counts()
    ms = scalar_chained_best_ms(
        lambda d, bump: wk.lerp_pass(d + bump, coef, n=32, c=3), x, reps=5)
    assert ms > 0
    assert wk.LAUNCHES["lerp_pass_kernel"] == 1 + 5


# -- the probes ported from scripts/ ----------------------------------------


@pytest.mark.parametrize("batch", [8192, 37])
def test_nnue_split_kernel_stages_equal_plain(cuda, batch):
    """K1's and K2's stages equal the plain sim's logits; the bf16 conv on
    the tensor cores equals the exact conv on normalized images and the
    CPU's float32 sums on any."""
    sim, cfg, head = profile_nnue_split.serve_model(profile_nnue_split.FLAGSHIP,
                                                    cuda)
    mega = nk.mega_head_params(sim, cfg, 32, 32)
    data = profile_nnue_split.input_buffers(batch, 32, 32, cuda, n_buf=1)
    stages = profile_nnue_split.stages(sim, cfg, head, mega, data)
    ref = stages["xla_full"]()
    nk.reset_launch_counts()
    for name in ("pallas_full", "mega_full", "mega_serve", "pallas_full_bf16conv",
                 "pallas_serve_bf16conv", "xla_full_bf16conv"):
        assert torch.equal(stages[name](), ref), name
    assert torch.equal(stages["head_pallas"](), ref)
    assert nk.LAUNCHES["nnue_mega_kernel"] == 2
    assert nk.LAUNCHES["nnue_head_kernel"] == 4
    x = data[0]
    assert torch.equal(profile_nnue_split.conv_bf16(sim, x, cfg),
                       profile_nnue_split.conv_f32(sim, x, cfg))
    wide = x * 4  # |qx| past 256: bf16 rounds, on the card as on the CPU
    got = profile_nnue_split.conv_bf16(sim, wide, cfg)
    cpu_sim = {k: v.cpu() for k, v in sim.items()}
    assert torch.equal(got.cpu(), profile_nnue_split.conv_bf16(cpu_sim, wide.cpu(),
                                                               cfg))
    assert not torch.equal(got, profile_nnue_split.conv_f32(sim, wide, cfg))


def test_etiny_pallas_paths_equal(cuda):
    kp, cfg = profile_etiny_pallas.serve_model("micro", cuda)
    data = profile_etiny_pallas.input_buffers(256, cuda)[:1]
    paths = profile_etiny_pallas.paths(kp, cfg, data)
    assert torch.equal(paths["pallas"](), paths["xla"]())
    tiles = profile_etiny_pallas.k6_tiles(
        profile_etiny_pallas.block_shapes(kp, cfg, data[0]), cuda)
    assert len(tiles) == len(cfg.blocks) and min(tiles) >= 1


def test_heavy_aug_k5_stage_equals_the_plain_chain(cuda):
    x = profile_heavy_aug.images(1024, 32, 32, cuda)
    stages = profile_heavy_aug.stages(
        x, profile_heavy_aug.draws(x, torch.Generator().manual_seed(0)))
    assert torch.equal(stages["medium_photometric_k5"](),
                       stages["medium_photometric_chain"]())


@pytest.mark.parametrize("strength", ["medium", "heavy"])
def test_photometric_rng_tiers_equal_plain(cuda, strength):
    """The tier with K5 and with the plain chain, on the same draws and the
    same device normals (the default generator seeded alike)."""
    x = torch.rand((512, 32, 32, 3), device=cuda)
    draws = {s: aug.draw_tier(torch.Generator().manual_seed(1), s, 512, 32, 32,
                              cuda) for s in ("medium", "heavy")}
    fns = profile_photometric_rng.tier_fns(draws)
    bump = torch.zeros((), device=cuda)
    torch.cuda.manual_seed(5)
    got = fns[f"tier_{strength}_pallas"](x, bump)
    torch.cuda.manual_seed(5)
    assert torch.equal(got, fns[f"tier_{strength}_xla"](x, bump))


NNUE_SMALL = NNUEConfig(feature_set=GridFeatureSet(4, 6), l1_size=16, l2_size=8,
                        l3_size=4, num_classes=10, input_size=12)
SCALED_SMALL = NNUEConfig(feature_set=GridFeatureSet(5, 8), l1_size=64,
                          l2_size=16, l3_size=8, num_classes=10, input_size=17)
ETINY_SMALL = EtinyNetConfig(variant="micro", num_classes=10, input_size=16)


@pytest.mark.parametrize("probe,kwargs", [
    (profile_train_roofline, dict(batch=16, spd=3, chunks=2, n_data=64,
                                  model_cfg=NNUE_SMALL)),
    (profile_train_sweep, dict(batches=(16,), fused=True, spds=(3,), images=64,
                               n_data=64, model_cfg=NNUE_SMALL)),
    (profile_train_sweep, dict(batches=(16,), spds=(3,), strength="heavy",
                               images=64, n_data=64, model_cfg=NNUE_SMALL)),
    (profile_scaled_train, dict(batch=16, spd=2, dispatches=2, n_data=64,
                                model_cfg=SCALED_SMALL)),
    (profile_etiny_roofline, dict(batch=16, steps=2, n_data=64, chunks=2,
                                  model_cfg=ETINY_SMALL)),
    (profile_etiny_train, dict(spds=(2,), batch=16, dispatches=2,
                               production_steps=2, n_data=64,
                               model_cfg=ETINY_SMALL)),
    (profile_heavy_aug, dict(batch=64, reps=2)),
    (profile_photometric_rng, dict(batch=64, reps=2)),
    (profile_batched_draws, dict(batch=64, reps=2)),
], ids=["roofline", "sweep-fused", "sweep-heavy", "scaled", "etiny-roofline",
        "etiny-train", "heavy-aug", "photometric-rng", "batched-draws"])
def test_probe_runs_on_the_card(cuda, probe, kwargs):
    """Each probe's graphs capture and replay at a small size."""
    out = probe.run(device="cuda", **kwargs)
    assert out["card"]
    if "train_mfu" in out:
        assert 0 < out["train_mfu"] < 1
    if probe is profile_etiny_roofline:  # `full` graph-timed, the loop beside it
        assert out["full_ms_per_step"] > 0 and out["full_prod_ms_per_step"] > 0
    if probe is profile_etiny_train:
        assert all(t > 0 for t in out["production_eager_ms_per_step"])
