"""The host-side plan of the persistent bulk-copy kernels (K4, its single
pass, K8 and K5): the grid and the single pass's tile, on the CPU.

The kernels themselves run only on a card (`tests/test_torch_augment_gpu.py`,
`tests/test_torch_probes_gpu.py`); what the host decides for them is plain
Python and is held here.
"""

import pytest
import torch

from nnue_vision_tpu_torch.ops import _ring
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


def test_cpu_tensors_never_plan_or_load(monkeypatch):
    """On the CPU the wrappers take the plain versions: no plan, no
    library."""
    def boom(*a, **k):
        raise AssertionError("a grid was planned for a CPU tensor")

    monkeypatch.setattr(_ring, "grid", boom)
    monkeypatch.setattr(_ring, "library", boom)
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
