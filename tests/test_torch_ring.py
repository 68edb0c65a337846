"""The host-side plan of the persistent bulk-copy kernels (K3, K4, its
single pass, K8 and K5): the grid, the single pass's tile and K3's bands,
on the CPU.

The kernels themselves run only on a card (`tests/test_torch_augment_gpu.py`,
`tests/test_torch_probes_gpu.py`, `tests/test_torch_input_pipeline_gpu.py`);
what the host decides for them is plain Python and is held here.
"""

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.ops import _build, _ring
from nnue_vision_tpu_torch.ops import input_pipeline as ip
from nnue_vision_tpu_torch.ops import photometric_kernel as pk
from nnue_vision_tpu_torch.ops import warp_kernel as wk

SMS = 132  # an H100 SXM


@pytest.mark.parametrize("batch", [1, 37, 131, 132, 133, 1024, 4096, 8192])
@pytest.mark.parametrize("per_sm", [8, 5, 3, 1])
def test_grid_size(batch, per_sm):
    grid = _ring.grid_size(batch, SMS, per_sm)
    assert grid == min(batch, SMS * per_sm)
    # every item has a block, no block is idle, and the load is even
    assert 1 <= grid <= batch
    blocks_items = [len(range(blk, batch, grid)) for blk in range(grid)]
    assert sum(blocks_items) == batch and min(blocks_items) >= 1
    assert max(blocks_items) - min(blocks_items) <= 1


@pytest.mark.parametrize("batch,per_sm,want", [
    # one wave fits: a block per image
    (1024, 8, 1024),
    (131, 1, 131),
    # past one wave: every resident block
    (8192, 8, 1056),
    (1024, 5, 660),
    (4096, 3, 396),
])
def test_grid_size_choices(batch, per_sm, want):
    assert _ring.grid_size(batch, SMS, per_sm) == want


def test_grid_size_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit shared memory"):
        _ring.grid_size(1024, SMS, 0)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64, 100, 1024, 2048])
def test_pass_tile_rows(n):
    rows = _ring.pass_tile_rows(n)
    assert rows >= 1
    # at most four cells per thread of 256, and as many rows as fit that
    assert rows * n <= _ring.TILE_CELLS or rows == 1
    assert (rows + 1) * n > _ring.TILE_CELLS


@pytest.mark.parametrize("n,tile_rows", [(32, 32), (16, 64)])
def test_pass_tiles_cover_every_row(n, tile_rows):
    """The single pass's tiles at the shapes the probe and the tests use:
    a ragged last tile where the row count is not a multiple."""
    assert _ring.pass_tile_rows(n) == tile_rows
    for batch, rows in ((1, 32), (37, 33), (1024, 32), (37, 21)):
        total = batch * rows
        items = -(-total // tile_rows)
        sizes = [min(tile_rows, total - i * tile_rows) for i in range(items)]
        assert sum(sizes) == total and min(sizes) >= 1


def _light_bands(h, w, plan):
    """K3's items of an h×w image as the kernel walks them: (y0, x0, rows,
    cols)."""
    for y0 in range(0, h, plan.rows):
        for x0 in range(0, w, plan.cols):
            yield y0, x0, min(plan.rows, h - y0), min(plan.cols, w - x0)


def _check_light_bands(h, w, plan):
    cover = np.zeros((h, w), np.int64)
    aligned = (h * w) % 4 == 0  # every image starts on a 16-byte boundary
    for y0, x0, rows, cols in _light_bands(h, w, plan):
        cover[y0:y0 + rows, x0:x0 + cols] += 1
        # whole rows, or a segment of one; the band's bytes fit the slot
        assert cols == w or rows == 1
        assert rows * cols * 3 * 4 <= ip.BAND_CELLS * 3 * 4
        # the output's start, the flipped source's start (the mirrored
        # columns) and the length, in pixels: a bulk copy takes them whole
        # when each is a multiple of 4 (12 bytes a pixel)
        ends = (y0 * w + x0, y0 * w + w - x0 - cols, rows * cols)
        aligned &= all(v % 4 == 0 for v in ends)
    assert (cover == 1).all(), "a pixel is not in exactly one band"
    assert plan.aligned == aligned


@pytest.mark.parametrize("h,w", [(32, 32), (10, 10), (16, 16), (77, 77),
                                 (96, 96), (224, 224)])
def test_light_band_plan(h, w):
    plan = ip.band_plan(h, w)
    _check_light_bands(h, w, plan)
    # aligned exactly when the image is whole 16-byte units
    assert plan.aligned == ((h * w) % 4 == 0)
    # the image whole up to BAND_CELLS pixels, else as many rows as fit
    if h * w <= ip.BAND_CELLS:
        assert (plan.rows, plan.cols) == (h, w)
    else:
        assert plan.cols == w and (plan.rows + 1) * w > ip.BAND_CELLS


@pytest.mark.parametrize("h,w,aligned", [
    (1, 1, False),
    (3, 5, False),
    (2, 1030, False),  # segments of a row wider than a band
    (4, 2048, True),
    (6, 1026, False),  # H·W % 4 == 0, but a row's segments are not aligned
    (8, 514, False),   # a band of one row of 514 pixels is not whole units
    (40, 110, True),   # 9 rows of 110 pixels trimmed to 8: 880 % 4 == 0
    (44, 99, True),    # 10 rows of 99 pixels trimmed to 8
    (33, 100, True),
])
def test_light_band_plan_edges(h, w, aligned):
    plan = ip.band_plan(h, w)
    _check_light_bands(h, w, plan)
    assert plan.aligned == aligned


def test_cpu_tensors_never_plan_or_load(monkeypatch):
    """On the CPU the wrappers take the plain versions: no plan, no
    library."""
    def boom(*a, **k):
        raise AssertionError("a grid was planned for a CPU tensor")

    monkeypatch.setattr(_ring, "grid", boom)
    monkeypatch.setattr(_build, "load_library", boom)
    x = torch.rand((2, 8, 8, 3))
    params = torch.zeros((2, wk.PARAMS))
    params[:, 2] = params[:, 5] = 1.0  # identity maps
    assert torch.equal(wk.warp_bilinear(x, params), x)
    packed = x.reshape(2, 8, 24)
    coef = torch.tensor([[0.0, 1.0, 0.0]] * 2)
    assert torch.equal(wk.lerp_pass(packed, coef, n=8, c=3), packed)
    f = torch.zeros((2, pk.MEDIUM_F))
    i = torch.zeros((2, pk.MEDIUM_I), dtype=torch.int32)
    assert torch.equal(pk.photometric_block(x, torch.zeros_like(x), f, i,
                                            variant="medium"), x)
    ds = ip.prepare_gather_dataset(torch.rand((4, 8, 8, 3)))
    idx = torch.tensor([0, 5, 3], dtype=torch.int32)  # 5: row 1 flipped
    p = ip.identity_light_params(1, 3)
    got = ip.fused_light_pipeline(ds, idx, p.pf[0], p.pi[0], h=8, w=8)
    rows = torch.stack([ds[0], ds[1].flip(1), ds[3]])
    assert torch.equal(got, ip.normalize_images(rows))
