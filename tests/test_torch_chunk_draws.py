"""A chunk's host draws from one generator call (`data/augment.py`
`draw_chunk`) against the per-step stream: K steps' draws made one
generator call a field by the draw helpers, the oracle of
`test_torch_augment.py`'s packing test. Every field of every step's packed
row is equal bit for bit (floats compared as their int32 bits, so a −0
against a +0 fails), and the generator ends in the same state: every tier,
K of 1 to 39, batches of 64, 1000 and 1024, both warp packings (32×32 for
K4, 224×224 for the gather) and a data-parallel shard.

The draws run on one intra-op thread and give the caller's thread count
back. The 2×2 products (`_mm`) are elementwise and summed from +0, as
`bmm`'s CPU kernel sums them: equal bit for bit to `m @ x` on matrices
with zero, −0 and ±1 entries besides floats. The fused light chunk's
`draw_light_params` is held the same way to eight calls over (K, B). The
file imports no jax.
"""

import pytest
import torch

from nnue_vision_tpu_torch.data import augment as aug

SEED = 2**31 + 4321


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _per_step(gen, tier, b, h, w):
    """One step's fields, each drawn by its own generator call."""
    if tier == "light":
        return [aug._bernoulli(gen, 0.5, b), *aug._bc_draw(gen, b, 0.2, 0.1),
                *aug._cutout_draw(gen, b, h, w, 0.2, (0.05, 0.051))]
    want = [aug._warp_params(aug.draw_medium_geometry(gen, b, h, w), h, w),
            *aug.draw_medium_photometric(gen, b, h, w)]
    if tier == "heavy":
        want += [aug._warp_params(aug.draw_heavy_geometry(gen, b, h, w), h, w),
                 *aug.draw_heavy_photometric(gen, b, h, w)]
    return want


@pytest.mark.parametrize("hw,shard", [(32, aug.WHOLE), (224, (1, 4))])
@pytest.mark.parametrize("b", [64, 1000, 1024])
@pytest.mark.parametrize("steps", [1, 2, 8, 39])
@pytest.mark.parametrize("tier", ["light", "medium", "heavy"])
def test_chunk_draw_equals_per_step_draws(tier, steps, b, hw, shard):
    chunk_gen = torch.Generator().manual_seed(SEED)
    calls = aug.DRAWS["host_draw_calls"]
    rows = aug.draw_chunk(chunk_gen, tier, steps, b, hw, hw, shard)
    assert aug.DRAWS["host_draw_calls"] - calls == 1
    mine = aug.shard_rows(b, shard)
    n = b // shard[1]
    assert rows.dtype == torch.int32 and rows.shape == (
        steps, aug.packed_size(aug.draw_specs(tier, n)))
    gen = torch.Generator().manual_seed(SEED)
    for k in range(steps):
        want = _per_step(gen, tier, b, hw, hw)
        got = aug.field_views(rows[k], aug.draw_specs(tier, n))
        for g, w in zip(got, want, strict=True):
            w = w[mine]
            assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    assert torch.equal(chunk_gen.get_state(), gen.get_state())


def _light_params_per_field(gen, steps, batch, h, w):
    """The fused chunk's light draws made one generator call a field over
    (steps, batch), folded to (flip, pf, pi): the derivation
    `draw_light_params` replaced."""
    shape = (steps, batch)
    flip = aug.uniform(gen, shape) < 0.5
    bc_apply = aug.uniform(gen, shape) < 0.2
    bright = aug.uniform(gen, shape, -0.1, 0.1)
    contr = 1.0 + aug.uniform(gen, shape, -0.1, 0.1)
    alpha = torch.where(bc_apply, contr, 1.0)
    beta = torch.where(bc_apply, 0.5 - 0.5 * contr + bright, 0.0)
    pf = torch.stack([alpha, beta], dim=-1).to(torch.float32)
    cut_apply = aug.uniform(gen, shape) < 0.2
    frac = aug.uniform(gen, shape, 0.05, 0.051)
    hh = torch.clamp((frac * h).to(torch.int32), min=1)
    ww = torch.clamp((frac * w).to(torch.int32), min=1)
    y0 = (aug.uniform(gen, shape) * (h - hh)).to(torch.int32)
    x0 = (aug.uniform(gen, shape) * (w - ww)).to(torch.int32)
    zero = torch.zeros_like(y0)
    pi = torch.stack([
        torch.where(cut_apply, y0, zero), torch.where(cut_apply, y0 + hh, zero),
        torch.where(cut_apply, x0, zero), torch.where(cut_apply, x0 + ww, zero),
    ], dim=-1).to(torch.int32)
    return flip, pf, pi


@pytest.mark.parametrize("steps,batch,h,w", [
    (1, 37, 32, 32), (39, 512, 32, 32), (2, 64, 77, 77), (8, 1000, 224, 224)])
def test_light_params_equal_per_field_draws(steps, batch, h, w):
    """The fused chunk's `draw_light_params`, one generator call a chunk,
    against eight calls over (steps, batch): flip, pf and pi bit for bit
    and the generator's state."""
    from nnue_vision_tpu_torch.ops.input_pipeline import draw_light_params

    gen = torch.Generator().manual_seed(SEED)
    calls = aug.DRAWS["host_draw_calls"]
    got = draw_light_params(gen, steps, batch, h, w)
    assert aug.DRAWS["host_draw_calls"] - calls == 1
    want_gen = torch.Generator().manual_seed(SEED)
    want = _light_params_per_field(want_gen, steps, batch, h, w)
    for g, w_ in zip(got, want, strict=True):
        assert g.shape == w_.shape and g.dtype == w_.dtype
        assert torch.equal(_bits(g), _bits(w_))
    assert torch.equal(gen.get_state(), want_gen.get_state())


def test_draw_batch_is_a_chunk_of_one_step():
    a, b = (torch.Generator().manual_seed(SEED) for _ in range(2))
    assert torch.equal(aug.draw_batch(a, "heavy", 96, 32, 32, (2, 4)),
                       aug.draw_chunk(b, "heavy", 1, 96, 32, 32, (2, 4))[0])
    assert torch.equal(a.get_state(), b.get_state())


def _matrices(rows: int, gen: torch.Generator) -> torch.Tensor:
    """(rows, 2, 2) float32 with entries 0, −0, ±1 and floats of either
    sign, as the composed rotations, flips and affines carry."""
    pick = torch.randint(0, 5, (rows, 2, 2), generator=gen)
    floats = torch.randn((rows, 2, 2), generator=gen)
    table = torch.tensor([0.0, -0.0, 1.0, -1.0])
    return torch.where(pick < 4, table[pick.clamp(max=3)], floats)


@pytest.mark.parametrize("rows", [1024, 8192, 39941])
def test_elementwise_2x2_product_equals_bmm(rows):
    gen = torch.Generator().manual_seed(rows)
    m, x = _matrices(rows, gen), _matrices(rows, gen)
    v = x[:, :, :1].contiguous()
    for rhs in (x, v):
        want = torch.bmm(m, rhs)
        got = aug._mm(m, rhs).contiguous()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the entry-major storage the draws use gives the same bits
    m_e = aug._m(m.permute(1, 2, 0).reshape(4, rows).contiguous())
    assert torch.equal(aug._mm(m_e, x).contiguous().view(torch.int32),
                       torch.bmm(m, x).view(torch.int32))


def test_chunk_draw_leaves_the_intra_op_threads_as_it_found_them():
    """The draws run on one intra-op thread and restore the caller's count."""
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        aug.draw_chunk(torch.Generator().manual_seed(SEED), "heavy", 2, 64,
                       32, 32)
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)
