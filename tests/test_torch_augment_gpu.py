"""The warp (K4) and photometric (K5) Hopper kernels held bit-equal to their
plain versions on a card, K5's band path for images past one shared-memory
slot (224×224, 160×200, and small images cut into many bands), a
heavy-tier batch at 32×32 and a medium one at 224×224 (the gather warp,
no K4) augmented on the card, and K4 refusing an odd side.

Marked `gpu`; each test skips where there is no CUDA device. The file
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_augment_gpu.py
"""

import pytest
import torch

from nnue_vision_tpu_torch.data import augment as taug
from nnue_vision_tpu_torch.ops import _ring
from nnue_vision_tpu_torch.ops import photometric_kernel as pk
from nnue_vision_tpu_torch.ops import warp_kernel as wk

pytestmark = pytest.mark.gpu

GATES = {"medium": [0, 3, 7, 8, 10, 11, 15, 20, 22, 23],
         "heavy_extra": [0, 3, 7, 8, 10, 11]}
# batches at the persistent grid's edges (132 SMs) and past one wave
EDGE_BATCHES = [1, 37, 131, 132, 133, 512, 1024, 4096]  # 512: a dp rank's shard
# the grid from the occupancy, one block per SM, and one block walking the
# whole batch through its slot
GRIDS = {"occupancy": None, "132": 132, "1": 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(params=list(GRIDS))
def plan(request, monkeypatch):
    forced = GRIDS[request.param]
    if forced is not None:
        monkeypatch.setattr(_ring, "grid", lambda dev, items, *shape: min(items, forced))
    return request.param


def _maps(m, v, b, n):
    return wk.pack_warp_params(*wk.warp_coefficients(
        m.expand(b, 2, 2).contiguous(), v.expand(b, 2).contiguous(), n, n))


@pytest.mark.parametrize("n,batch", [(32, 1024), (32, 37), (16, 5)])
def test_warp_kernel_equals_plain(cuda, n, batch):
    gen = torch.Generator().manual_seed(n + batch)
    x = torch.rand((batch, n, n, 3), generator=gen).to(cuda)
    draws = taug.draw_tier(gen, "heavy", batch, n, n, cuda)
    eye = torch.eye(2)
    cases = [draws.warp1, draws.warp2,
             _maps(torch.tensor([[0.0, 1.0], [-1.0, 0.0]]), torch.zeros(2), batch, n),
             _maps(torch.tensor([[1.0, 0.0], [0.0, -1.0]]), torch.zeros(2), batch, n),
             _maps(eye, torch.tensor([100.0, -70.0]), batch, n)]
    for params in cases:
        params = params.to(cuda)
        before = wk.LAUNCHES["warp_kernel"]
        got = wk.warp_bilinear(x, params)
        assert wk.LAUNCHES["warp_kernel"] == before + 1
        want = wk.warp_bilinear_reference(x, params)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(wk.warp_bilinear(x, cases[-1].to(cuda)), torch.zeros_like(x))


@pytest.mark.parametrize("variant", ["medium", "heavy_extra"])
@pytest.mark.parametrize("batch", [1024, 37])
def test_photometric_kernel_equals_plain(cuda, variant, batch):
    gen = torch.Generator().manual_seed(batch)
    draw = (taug.draw_medium_photometric if variant == "medium"
            else taug.draw_heavy_photometric)
    f, i = draw(gen, batch, 32, 32)
    x = torch.rand((batch, 32, 32, 3), generator=gen).to(cuda)
    noise = torch.randn((batch, 32, 32, 3), generator=gen).to(cuda)
    on, off = f.clone(), f.clone()
    on[:, GATES[variant]] = 1.0
    off[:, GATES[variant]] = 0.0
    for fp in (f, on, off):
        args = (x, noise, fp.to(cuda), i.to(cuda))
        before = pk.LAUNCHES["photometric_kernel"]
        got = pk.photometric_block(*args, variant=variant)
        assert pk.LAUNCHES["photometric_kernel"] == before + 1
        want = pk.photometric_block_reference(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(pk.photometric_block(x, noise, off.to(cuda), i.to(cuda),
                                            variant=variant), x)


def test_heavy_batch_on_the_card(cuda):
    """augment_batch on a CUDA tensor launches two warps and two blocks and
    gives the same pixels as the plain versions on the same draws."""
    images = torch.rand((256, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    images = images.to(cuda)
    w0, p0 = wk.LAUNCHES["warp_kernel"], pk.LAUNCHES["photometric_kernel"]
    draws = taug.draw_tier(torch.Generator().manual_seed(3), "heavy", 256, 32, 32, cuda)
    got = taug.apply_tier(images, draws, torch.Generator(device=cuda).manual_seed(4))
    assert wk.LAUNCHES["warp_kernel"] == w0 + 2
    assert pk.LAUNCHES["photometric_kernel"] == p0 + 2
    noise_gen = torch.Generator(device=cuda).manual_seed(4)
    x = wk.warp_bilinear_reference(images, draws.warp1)
    x = pk.photometric_block_reference(
        x, torch.randn(x.shape, generator=noise_gen, device=cuda), *draws.photo1,
        variant="medium")
    x = wk.warp_bilinear_reference(x, draws.warp2)
    x = pk.photometric_block_reference(
        x, torch.randn(x.shape, generator=noise_gen, device=cuda), *draws.photo2,
        variant="heavy_extra")
    torch.cuda.synchronize()
    assert torch.equal(got, x)


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("batch", EDGE_BATCHES)
def test_warp_kernel_at_the_ring_edges(cuda, plan, n, batch):
    """Drawn maps, and rot90 maps that swap every image, at batches that
    end a grid early, exactly and one over, and that walk several images
    a block."""
    gen = torch.Generator().manual_seed(7 * n + batch)
    x = torch.rand((batch, n, n, 3), generator=gen).to(cuda)
    draws = taug.draw_tier(gen, "heavy", batch, n, n, cuda)
    swapped = _maps(torch.tensor([[0.0, 1.0], [-1.0, 0.0]]), torch.tensor([0.3, -0.6]),
                    batch, n).to(cuda)
    assert bool((swapped[:, 0] > 0.5).all())
    for params in (draws.warp1, swapped):
        got = wk.warp_bilinear(x, params)
        torch.cuda.synchronize()
        assert torch.equal(got, wk.warp_bilinear_reference(x, params))


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("batch", EDGE_BATCHES)
@pytest.mark.parametrize("variant", ["medium", "heavy_extra"])
def test_photometric_kernel_each_gate_alone(cuda, plan, variant, n, batch):
    """Every gate on alone (the noise image read only under gate 8), at
    the grid's edges and past one wave."""
    gen = torch.Generator().manual_seed(11 * n + batch)
    draw = (taug.draw_medium_photometric if variant == "medium"
            else taug.draw_heavy_photometric)
    f, i = draw(gen, batch, n, n)
    x = torch.rand((batch, n, n, 3), generator=gen).to(cuda)
    noise = torch.randn((batch, n, n, 3), generator=gen).to(cuda)
    for gate in GATES[variant]:
        fp = f.clone()
        fp[:, GATES[variant]] = 0.0
        fp[:, gate] = 1.0
        args = (x, noise, fp.to(cuda), i.to(cuda))
        got = pk.photometric_block(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, pk.photometric_block_reference(*args, variant=variant)), gate


def test_ring_wrappers_refuse(cuda):
    """A CUDA tensor reaches the kernel or raises: three channels, 16-byte
    units and aligned starts."""
    x = torch.rand((4, 32, 32, 3), device=cuda)
    params = wk.pack_warp_params(*wk.warp_coefficients(
        torch.eye(2).expand(4, 2, 2).contiguous(), torch.zeros((4, 2)), 32, 32)).to(cuda)
    with pytest.raises(ValueError, match="n even"):
        wk.warp_bilinear(torch.rand((4, 5, 5, 3), device=cuda), params)
    with pytest.raises(ValueError, match="float32"):
        wk.warp_bilinear(x.double(), params)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.rand(4 * 32 * 32 * 3 + 1, device=cuda)
        wk.warp_bilinear(flat[1:].view(4, 32, 32, 3), params)
    f = torch.zeros((4, pk.MEDIUM_F), device=cuda)
    i = torch.zeros((4, pk.MEDIUM_I), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte units"):
        y = torch.rand((4, 5, 5, 3), device=cuda)
        pk.photometric_block(y, y, f, i, variant="medium")
    with pytest.raises(ValueError, match="int32"):
        pk.photometric_block(x, x, f, i.long(), variant="medium")


@pytest.mark.parametrize("b,h,w", [(256, 224, 224), (37, 224, 224), (37, 160, 200),
                                   (5, 100, 100)])
@pytest.mark.parametrize("variant", ["medium", "heavy_extra"])
def test_photometric_band_path_equals_plain(cuda, variant, b, h, w):
    """Images past one shared-memory slot take the band path (one count
    per call), with every gate on, drawn and off."""
    assert not pk.slot_fits(h, w)
    gen = torch.Generator().manual_seed(b + h + w)
    draw = (taug.draw_medium_photometric if variant == "medium"
            else taug.draw_heavy_photometric)
    f, i = draw(gen, b, h, w)
    x = torch.rand((b, h, w, 3), generator=gen).to(cuda)
    noise = torch.randn((b, h, w, 3), generator=gen).to(cuda)
    on, off = f.clone(), f.clone()
    on[:, GATES[variant]] = 1.0
    off[:, GATES[variant]] = 0.0
    for fp in (f, on, off):
        args = (x, noise, fp.to(cuda), i.to(cuda))
        before = dict(pk.LAUNCHES)
        got = pk.photometric_block(*args, variant=variant)
        assert pk.LAUNCHES["photometric_band_kernel"] == before["photometric_band_kernel"] + 1
        assert pk.LAUNCHES["photometric_kernel"] == before["photometric_kernel"]
        want = pk.photometric_block_reference(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(got, x)


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("b,h,w", [(7, 8, 8), (5, 13, 12), (3, 3, 4)])
@pytest.mark.parametrize("variant", ["medium", "heavy_extra"])
def test_photometric_band_path_at_small_shapes(cuda, monkeypatch, variant, b, h, w,
                                               rows):
    """The band path forced onto small images cut into many bands: band
    edges, the halo rows of the blur and the equalize across bands."""
    monkeypatch.setattr(pk, "slot_fits", lambda h, w: False)
    monkeypatch.setattr(pk, "band_rows", lambda w: rows)
    gen = torch.Generator().manual_seed(b * h * w + rows)
    draw = (taug.draw_medium_photometric if variant == "medium"
            else taug.draw_heavy_photometric)
    f, i = draw(gen, b, h, w)
    x = torch.rand((b, h, w, 3), generator=gen).to(cuda)
    noise = torch.randn((b, h, w, 3), generator=gen).to(cuda)
    for gate in [None] + GATES[variant]:
        fp = f.clone()
        if gate is not None:
            fp[:, GATES[variant]] = 0.0
            fp[:, gate] = 1.0
        args = (x, noise, fp.to(cuda), i.to(cuda))
        got = pk.photometric_block(*args, variant=variant)
        torch.cuda.synchronize()
        assert torch.equal(got, pk.photometric_block_reference(*args, variant=variant)), gate


def test_medium_batch_at_224_on_the_card(cuda):
    """augment_batch at 224×224: the gather warp (no K4 launch) and one K5
    launch on the band path, equal to the plain versions on the same
    draws."""
    images = torch.rand((16, 224, 224, 3), generator=torch.Generator().manual_seed(5))
    images = images.to(cuda)
    w0, p0 = wk.LAUNCHES["warp_kernel"], dict(pk.LAUNCHES)
    draws = taug.draw_tier(torch.Generator().manual_seed(6), "medium", 16, 224, 224, cuda)
    got = taug.apply_tier(images, draws, torch.Generator(device=cuda).manual_seed(7))
    assert wk.LAUNCHES["warp_kernel"] == w0
    assert pk.LAUNCHES["photometric_band_kernel"] == p0["photometric_band_kernel"] + 1
    assert pk.LAUNCHES["photometric_kernel"] == p0["photometric_kernel"]
    x = taug.warp_gather(images, draws.warp1)
    x = pk.photometric_block_reference(
        x, torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(7),
                       device=cuda), *draws.photo1, variant="medium")
    torch.cuda.synchronize()
    assert torch.equal(got, x)


def test_odd_square_in_the_two_pass_range_raises(cuda):
    """A 33×33 batch takes the two-pass by JAX's rule; K4 wants an even n
    and raises rather than fall back to the plain two-pass."""
    assert taug.two_pass_warp(33, 33)
    draws = taug.draw_tier(torch.Generator().manual_seed(8), "medium", 4, 33, 33, cuda)
    with pytest.raises(ValueError, match="n even"):
        taug.warp(torch.rand((4, 33, 33, 3), device=cuda), draws.warp1)
