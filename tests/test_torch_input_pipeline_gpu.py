"""The light-pipeline Hopper kernel (K3) held bit-equal to its plain version
on a card: the flagship 32×32 at small and large batches, images that are
not whole 16-byte units (77×77), images split into bands (96×96, 224×224)
or rows split into segments, batches below and above the persistent grid,
the edge indices, and a call replayed from a CUDA graph.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_input_pipeline_gpu.py
"""

import numpy as np
import pytest
import torch

from nnue_vision_tpu_torch.data.augment import normalize_images
from nnue_vision_tpu_torch.ops import _ring
from nnue_vision_tpu_torch.ops import input_pipeline as ip

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dataset(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((n, h, w, 3), np.float32))


@pytest.mark.parametrize("h,w,batch", [(32, 32, 512), (32, 32, 256), (16, 16, 37),
                                       (10, 10, 12)])
def test_kernel_equals_plain(cuda, h, w, batch):
    n = 64
    ds = ip.prepare_gather_dataset(_dataset(n, h, w).to(cuda))
    gen = torch.Generator().manual_seed(batch)
    for _ in range(3):
        p = ip.draw_light_params(gen, 1, batch, h, w)
        idx = torch.randint(0, n, (batch,), generator=gen)
        idx_eff = (idx + n * p.flip[0]).to(torch.int32).to(cuda)
        args = (ds, idx_eff, p.pf[0].to(cuda), p.pi[0].to(cuda))
        before = ip.LAUNCHES["light_pipeline_kernel"]
        got = ip.fused_light_pipeline(*args, h=h, w=w)
        assert ip.LAUNCHES["light_pipeline_kernel"] == before + 1
        want = ip.fused_light_pipeline_reference(*args, h=h, w=w)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_identity_equals_normalize(cuda):
    n, batch = 40, 64
    ds = ip.prepare_gather_dataset(_dataset(n, 32, 32, seed=1).to(cuda))
    idx = torch.arange(batch, dtype=torch.int32, device=cuda) % n
    p = ip.identity_light_params(1, batch)
    got = ip.fused_light_pipeline(ds, idx, p.pf[0].to(cuda), p.pi[0].to(cuda),
                                  h=32, w=32)
    assert torch.equal(got, normalize_images(ds[idx.long()]))


def test_out_of_range_index_writes_nan(cuda):
    ds = ip.prepare_gather_dataset(_dataset(8, 32, 32).to(cuda))
    idx = torch.tensor([0, 16, -1, 15], dtype=torch.int32, device=cuda)
    p = ip.identity_light_params(1, 4)
    got = ip.fused_light_pipeline(ds, idx, p.pf[0].to(cuda), p.pi[0].to(cuda),
                                  h=32, w=32)
    assert torch.isfinite(got[[0, 3]]).all()
    assert torch.isnan(got[[1, 2]]).all()


def test_wrong_dtype_raises(cuda):
    ds = ip.prepare_gather_dataset(_dataset(8, 32, 32).to(cuda))
    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    p = ip.identity_light_params(1, 4)
    with pytest.raises(ValueError, match="idx_eff"):
        ip.fused_light_pipeline(ds, idx, p.pf[0].to(cuda), p.pi[0].to(cuda),
                                h=32, w=32)


def _drawn_args(ds, batch, seed, idx=None):
    """(dataset, idx_eff, pf, pi) on the dataset's device, with every branch
    drawn: flips, α ≠ 1 and holes (a hole of at least 3×3, so that a band's
    edge can cut it)."""
    n, h, w, _ = ds.shape
    rng = np.random.default_rng(seed)
    if idx is None:
        idx = rng.integers(0, 2 * n, batch)
    bc = rng.random(batch) < 0.5
    contr = 1.0 + rng.uniform(-0.1, 0.1, batch)
    pf = np.stack([np.where(bc, contr, 1.0),
                   np.where(bc, 0.5 - 0.5 * contr + rng.uniform(-0.1, 0.1, batch),
                            0.0)], -1).astype(np.float32)
    hh, ww = min(h, max(3, h // 10)), min(w, max(3, w // 10))
    y0 = rng.integers(0, h - hh + 1, batch)
    x0 = rng.integers(0, w - ww + 1, batch)
    cut = rng.random(batch) < 0.5
    pi = np.stack([np.where(cut, y0, 0), np.where(cut, y0 + hh, 0),
                   np.where(cut, x0, 0), np.where(cut, x0 + ww, 0)],
                  -1).astype(np.int32)
    dev = ds.device
    return (ds, torch.from_numpy(np.asarray(idx, np.int32)).to(dev),
            torch.from_numpy(pf).to(dev), torch.from_numpy(pi).to(dev))


def _held(args, h, w):
    before = ip.LAUNCHES["light_pipeline_kernel"]
    got = ip.fused_light_pipeline(*args, h=h, w=w)
    assert ip.LAUNCHES["light_pipeline_kernel"] == before + 1
    want = ip.fused_light_pipeline_reference(*args, h=h, w=w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("h,w,batch", [
    (77, 77, 37),    # unaligned: 77·77·12 bytes is not whole 16-byte units
    (224, 224, 8),   # banded: 56 bands of 4 rows
    (96, 96, 5),     # banded, a short last band
    (32, 32, 8192),  # the flagship size, many items per block
    (32, 32, 1),
    (3, 5, 7),       # unaligned, fewer values than a 16-byte unit per row
    (1, 1, 9),       # three values an image: no bulk copy at all
    (2, 1030, 3),    # rows wider than a band: segments, unaligned
])
def test_kernel_equals_plain_banded_and_unaligned(cuda, h, w, batch):
    n = 16
    full = ip.prepare_gather_dataset(_dataset(n + 1, h, w, seed=h + w).to(cuda))
    # an unaligned shape's dataset view starts off a 16-byte boundary
    ds = full[1:] if (h * w) % 4 else full[:n]
    _held(_drawn_args(ds, batch, seed=batch), h, w)


def test_batch_below_and_above_the_grid(cuda):
    n, h, w = 64, 32, 32
    ds = ip.prepare_gather_dataset(_dataset(n, h, w, seed=2).to(cuda))
    rows, cols, _ = ip.band_plan(h, w)
    dev = ds.device  # with its index
    resident = _ring.grid(dev, 1 << 20, "light_pipeline_blocks_per_sm", rows, cols)
    for batch in (resident // 2, resident - 1, resident + 1, 3 * resident + 7):
        assert _ring.grid(dev, batch, "light_pipeline_blocks_per_sm", rows,
                          cols) == min(batch, resident)
        _held(_drawn_args(ds, batch, seed=batch), h, w)


@pytest.mark.parametrize("h,w", [(32, 32), (77, 77), (224, 224)])
def test_edge_indices(cuda, h, w):
    n = 5
    ds = ip.prepare_gather_dataset(_dataset(n, h, w, seed=3).to(cuda))
    idx = [0, n - 1, n, 2 * n - 1]
    got = _held(_drawn_args(ds, 4, seed=4, idx=idx), h, w)
    assert torch.isfinite(got).all()


def test_graph_replay_equals_eager(cuda):
    n, h, w, batch = 64, 32, 32, 512
    ds = ip.prepare_gather_dataset(_dataset(n, h, w, seed=5).to(cuda))
    args = _drawn_args(ds, batch, seed=6)
    eager = ip.fused_light_pipeline(*args, h=h, w=w)  # plans the grid
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = ip.LAUNCHES["light_pipeline_kernel"]
    with torch.cuda.graph(graph):
        got = ip.fused_light_pipeline(*args, h=h, w=w)
    assert ip.LAUNCHES["light_pipeline_kernel"] == before + 1
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, eager)
    assert torch.equal(got, ip.fused_light_pipeline_reference(*args, h=h, w=w))
