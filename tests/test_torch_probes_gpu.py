"""The profiling probes' kernels held bit-equal to their plain versions on a
card: the cut mega kernel (K7) at every level, with both threshold signs,
and the single warp pass with and without its gather (`lerp_pass`, K8's
`nogather_pass`); and the CUDA-graph timing harness.

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
from nnue_vision_tpu_torch.ops.timing import chained_best_ms

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
